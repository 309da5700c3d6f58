"""gRPC client stubs and servicer bases for the LMS wire contract.

The environment has no ``grpcio-tools``/``protoc-gen-grpc`` plugin, so instead
of vendoring a thousand lines of generated boilerplate (reference:
GUI_RAFT_LLM_SourceCode/lms_pb2_grpc.py) we build the stub and servicer
classes programmatically from a declarative service table. The wire behavior
is identical to protoc-generated code: method paths are
``/<package>.<Service>/<Method>`` and payloads are the ``lms_pb2`` messages.

Usage mirrors generated code::

    stub = LMSStub(channel)
    resp = stub.Login(lms_pb2.LoginRequest(username=u, password=p))

    class MyLMS(LMSServicer): ...
    add_LMSServicer_to_server(MyLMS(), server)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import grpc
from google.protobuf import symbol_database

from . import lms_pb2

_PACKAGE = "lms"


def _load_services() -> Dict[str, Dict[str, Tuple[Any, Any, str]]]:
    """Derive {service: {method: (req_cls, resp_cls, arity)}} from the
    generated descriptor so stubs/servicers can never drift from lms.proto.

    arity: "uu" = unary-unary, "su" = stream-unary, "us" = unary-stream
    (server streaming, e.g. StreamLLMAnswer). Bidirectional streaming is not
    part of the contract and asserts below.
    """
    sym_db = symbol_database.Default()
    services: Dict[str, Dict[str, Tuple[Any, Any, str]]] = {}
    for service_name, service in lms_pb2.DESCRIPTOR.services_by_name.items():
        methods = {}
        for method in service.methods:
            req = sym_db.GetSymbol(method.input_type.full_name)
            resp = sym_db.GetSymbol(method.output_type.full_name)
            assert not (method.client_streaming and method.server_streaming), method.full_name
            if method.server_streaming:
                arity = "us"
            elif method.client_streaming:
                arity = "su"
            else:
                arity = "uu"
            methods[method.name] = (req, resp, arity)
        services[service_name] = methods
    return services


_SERVICES = _load_services()


def _make_stub_class(service: str, methods: Dict[str, Tuple[Any, Any, str]]):
    def __init__(self, channel: grpc.Channel):
        for name, (req, resp, arity) in methods.items():
            path = f"/{_PACKAGE}.{service}/{name}"
            if arity == "uu":
                handle = channel.unary_unary(
                    path,
                    request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString,
                )
            elif arity == "us":  # server streaming
                handle = channel.unary_stream(
                    path,
                    request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString,
                )
            else:  # stream-unary
                handle = channel.stream_unary(
                    path,
                    request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString,
                )
            setattr(self, name, handle)

    return type(f"{service}Stub", (object,), {"__init__": __init__, "__doc__": f"Client stub for lms.{service}."})


def _unimplemented(name: str):
    def method(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details(f"Method {name} not implemented")
        raise NotImplementedError(name)

    method.__name__ = name
    return method


def _make_servicer_class(service: str, methods: Dict[str, Tuple[Any, Any, str]]):
    ns = {name: _unimplemented(name) for name in methods}
    ns["__doc__"] = f"Servicer base for lms.{service}; override the RPC methods."
    return type(f"{service}Servicer", (object,), ns)


def _make_adder(service: str, methods: Dict[str, Tuple[Any, Any, str]]):
    def adder(servicer, server: grpc.Server) -> None:
        handlers = {}
        for name, (req, resp, arity) in methods.items():
            if arity == "uu":
                factory = grpc.unary_unary_rpc_method_handler
            elif arity == "us":
                factory = grpc.unary_stream_rpc_method_handler
            else:
                factory = grpc.stream_unary_rpc_method_handler
            handlers[name] = factory(
                getattr(servicer, name),
                request_deserializer=req.FromString,
                response_serializer=resp.SerializeToString,
            )
        generic = grpc.method_handlers_generic_handler(f"{_PACKAGE}.{service}", handlers)
        server.add_generic_rpc_handlers((generic,))

    adder.__name__ = f"add_{service}Servicer_to_server"
    return adder


_g = globals()
for _service, _methods in _SERVICES.items():
    _g[f"{_service}Stub"] = _make_stub_class(_service, _methods)
    _g[f"{_service}Servicer"] = _make_servicer_class(_service, _methods)
    _g[f"add_{_service}Servicer_to_server"] = _make_adder(_service, _methods)

__all__ = sorted(
    [f"{s}Stub" for s in _SERVICES]
    + [f"{s}Servicer" for s in _SERVICES]
    + [f"add_{s}Servicer_to_server" for s in _SERVICES]
)
