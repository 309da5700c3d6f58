"""Regenerate the port's proto/lms_pb2.py with the additive streaming
contract, without `protoc` or `grpcio-tools`.

    python -m distributed_lms_raft_llm_tpu_torch.tools.regen_proto_stream

The server-streaming additions (StreamRequest / StreamChunk /
StreamLLMAnswer) cannot be produced by recompiling lms.proto here, so this
tool edits the *descriptor*: it parses the serialized FileDescriptorProto
embedded in lms_pb2.py, strips any previous streaming additions (a re-run
writes the same bytes), appends the streaming messages and methods, and
rewrites lms_pb2.py around the new blob. The port's copy of the module is
byte-equal to the JAX package's, and so is what the two tools write.

The edit is additive only: every pre-existing message, service, method,
field name and tag is byte-identical after a round trip, so the frozen
wire contract (lms.proto's header) is untouched.
"""

from __future__ import annotations

import argparse
import ast
import pathlib
import re
import sys

from google.protobuf import descriptor_pb2

PB2_PATH = pathlib.Path(__file__).resolve().parents[1] / "proto" / "lms_pb2.py"

STREAM_MESSAGES = ("StreamRequest", "StreamChunk")
STREAM_METHOD = "StreamLLMAnswer"
STREAM_SERVICES = ("LMS", "Tutoring")

_STRING = descriptor_pb2.FieldDescriptorProto.TYPE_STRING
_BOOL = descriptor_pb2.FieldDescriptorProto.TYPE_BOOL
_INT32 = descriptor_pb2.FieldDescriptorProto.TYPE_INT32
_OPTIONAL = descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL


def _field(name: str, number: int, ftype: int) -> descriptor_pb2.FieldDescriptorProto:
    return descriptor_pb2.FieldDescriptorProto(
        name=name, number=number, type=ftype, label=_OPTIONAL
    )


def _stream_request() -> descriptor_pb2.DescriptorProto:
    msg = descriptor_pb2.DescriptorProto(name="StreamRequest")
    msg.field.extend(
        [
            _field("token", 1, _STRING),
            _field("query", 2, _STRING),
            # Session id for multi-turn tutoring; empty = one-shot question.
            _field("session_id", 3, _STRING),
            # Resume point: token offset already delivered to the client.
            # 0 = fresh stream.
            _field("resume_offset", 4, _INT32),
        ]
    )
    return msg


def _stream_chunk() -> descriptor_pb2.DescriptorProto:
    msg = descriptor_pb2.DescriptorProto(name="StreamChunk")
    msg.field.extend(
        [
            _field("success", 1, _BOOL),
            _field("text", 2, _STRING),
            # Token offset of the first token in this chunk; offsets are
            # monotone and gap-free within a logical stream.
            _field("offset", 3, _INT32),
            # Number of tokens in this chunk.
            _field("count", 4, _INT32),
            _field("final", 5, _BOOL),
            # sha256 hexdigest of the *full* answer text (offset 0..end);
            # set only on the final chunk so resumed clients can verify
            # their spliced transcript against the canonical answer.
            _field("digest", 6, _STRING),
        ]
    )
    return msg


def regenerate() -> bytes:
    """The bytes of the port's lms_pb2.py with the streaming additions
    appended afresh to its serialized descriptor."""
    src = PB2_PATH.read_text()
    m = re.search(r"AddSerializedFile\((b'(?:[^'\\]|\\.)*')\)", src)
    if not m:
        raise SystemExit("could not locate serialized descriptor in lms_pb2.py")
    blob = ast.literal_eval(m.group(1))

    fd = descriptor_pb2.FileDescriptorProto.FromString(blob)

    # Idempotency: strip a previous run's additions before re-appending.
    kept = [msg for msg in fd.message_type if msg.name not in STREAM_MESSAGES]
    del fd.message_type[:]
    fd.message_type.extend(kept)
    for svc in fd.service:
        kept_methods = [mt for mt in svc.method if mt.name != STREAM_METHOD]
        del svc.method[:]
        svc.method.extend(kept_methods)

    fd.message_type.append(_stream_request())
    fd.message_type.append(_stream_chunk())
    for svc in fd.service:
        if svc.name in STREAM_SERVICES:
            svc.method.append(
                descriptor_pb2.MethodDescriptorProto(
                    name=STREAM_METHOD,
                    input_type=".lms.StreamRequest",
                    output_type=".lms.StreamChunk",
                    server_streaming=True,
                )
            )

    new_blob = fd.SerializeToString()

    header = '''# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: lms.proto
#
# Regenerated by scripts/regen_proto_stream.py: the streaming additions
# (StreamRequest, StreamChunk, StreamLLMAnswer on LMS + Tutoring) are
# appended at the descriptor level because the build environment has no
# protoc. All pre-existing messages/services are byte-identical.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile({blob!r})

_globals = globals()
_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, _globals)
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'lms_pb2', _globals)
if _descriptor._USE_C_DESCRIPTORS == False:
  DESCRIPTOR._options = None
# @@protoc_insertion_point(module_scope)
'''.format(blob=new_blob)
    return header.encode()


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    PB2_PATH.write_bytes(regenerate())
    print(f"wrote {PB2_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
