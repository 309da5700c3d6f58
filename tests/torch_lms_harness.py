"""LMS clusters of either package, or of both, over gRPC on 127.0.0.1.

`PACKAGES["jax"]` and `PACKAGES["port"]` name the same pieces of the JAX
package and of the port (`LMSNode`, `LMSServicer`, the servicers, the
stubs, the client), so one harness starts a node of either kind; a mixed
cluster is one Raft group whose members are of both kinds. `LoopThread`
runs the cluster's event loop on a thread of its own, so a test drives it
with the (blocking) `LMSClient` as a student would.

`GroupedCluster` is the sharded control plane in process, as the LMS
server wires it with `--groups N`: every member hosts one `LMSNode` of
each group (group g > 0 under `node<i>/group<g>`, on a Raft address of its
own, sharing group 0's blob store) and one `RoutedLMSServicer` on its LMS
address. Members of either package can share it (a mixed cluster routes
port -> JAX -> port).
"""

import asyncio
import threading
import types

import grpc

from distributed_lms_raft_llm_tpu import client as jax_client
from distributed_lms_raft_llm_tpu.lms import group_router as jax_router
from distributed_lms_raft_llm_tpu.lms import node as jax_node
from distributed_lms_raft_llm_tpu.lms import service as jax_service
from distributed_lms_raft_llm_tpu.proto import rpc as jax_rpc
from distributed_lms_raft_llm_tpu.raft import RaftConfig as JaxRaftConfig
from distributed_lms_raft_llm_tpu.raft import grpc_transport as jax_transport
from distributed_lms_raft_llm_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_lms_raft_llm_tpu_torch import client as port_client
from distributed_lms_raft_llm_tpu_torch.lms import group_router as port_router
from distributed_lms_raft_llm_tpu_torch.lms import node as port_node
from distributed_lms_raft_llm_tpu_torch.lms import service as port_service
from distributed_lms_raft_llm_tpu_torch.proto import rpc as port_rpc
from distributed_lms_raft_llm_tpu_torch.raft import RaftConfig as PortRaftConfig
from distributed_lms_raft_llm_tpu_torch.raft import grpc_transport as port_transport
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics as PortMetrics

# The JAX tests' fast timing (elections 0.11-0.22 s, heartbeats 0.05 s).
FAST = dict(election_timeout_min=0.11, election_timeout_max=0.22,
            heartbeat_interval=0.05)

PACKAGES = {
    "jax": types.SimpleNamespace(
        name="jax", LMSNode=jax_node.LMSNode,
        LMSServicer=jax_service.LMSServicer,
        FileTransferServicer=jax_service.FileTransferServicer,
        RaftServicer=jax_transport.RaftServicer, rpc=jax_rpc,
        RaftConfig=JaxRaftConfig, LMSClient=jax_client.LMSClient,
        router=jax_router, Metrics=JaxMetrics),
    "port": types.SimpleNamespace(
        name="port", LMSNode=port_node.LMSNode,
        LMSServicer=port_service.LMSServicer,
        FileTransferServicer=port_service.FileTransferServicer,
        RaftServicer=port_transport.RaftServicer, rpc=port_rpc,
        RaftConfig=PortRaftConfig, LMSClient=port_client.LMSClient,
        router=port_router, Metrics=PortMetrics),
}


class LoopThread:
    """An event loop on a daemon thread; `run` waits for a coroutine."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        daemon=True)
        self._thread.start()

    def run(self, coro, timeout=30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(10)
        self.loop.close()


class Member:
    """One LMS node and its gRPC server."""

    def __init__(self, pkg, nid, address, data_dir, servicer_kwargs):
        self.pkg, self.nid, self.address = pkg, nid, address
        self.data_dir = data_dir
        self.servicer_kwargs = servicer_kwargs
        self.node = self.server = self.servicer = None

    async def start(self, addresses):
        pkg = self.pkg
        self.node = pkg.LMSNode(self.nid, addresses, self.data_dir,
                                raft_config=pkg.RaftConfig(**FAST))
        self.servicer = pkg.LMSServicer(
            self.node.node, self.node.state, self.node.blobs,
            peer_addresses=self.node.addresses, self_id=self.nid,
            **self.servicer_kwargs)
        self.server = grpc.aio.server(options=[
            ("grpc.max_receive_message_length", 50 * 1024 * 1024)])
        pkg.rpc.add_LMSServicer_to_server(self.servicer, self.server)
        pkg.rpc.add_RaftServiceServicer_to_server(
            pkg.RaftServicer(self.node.node, self.node.addresses,
                             kv=self.node.state.data["kv"]), self.server)
        pkg.rpc.add_FileTransferServiceServicer_to_server(
            pkg.FileTransferServicer(self.node.blobs), self.server)
        self.server.add_insecure_port(self.address)
        await self.server.start()
        await self.node.start()

    async def stop(self):
        if self.node is not None and not self.node.node._stopped:
            await self.node.stop()
        if self.server is not None:
            await self.server.stop(None)

    @property
    def alive(self):
        return self.node is not None and not self.node.node._stopped


def free_addresses(n):
    """n distinct 127.0.0.1 ports, free when probed."""
    import socket

    socks, out = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        out.append(f"127.0.0.1:{s.getsockname()[1]}")
    for s in socks:
        s.close()
    return out


class Cluster:
    """LMS members of the given kinds (`["port", "jax", "port"]`), ids
    1..N, sharing `servicer_kwargs` (the gate, the tutoring pool)."""

    def __init__(self, kinds, tmp_path, **servicer_kwargs):
        self.loop = LoopThread()
        addrs = free_addresses(len(kinds))
        self.addresses = {i + 1: a for i, a in enumerate(addrs)}
        self.members = {
            i + 1: Member(PACKAGES[k], i + 1, addrs[i],
                          str(tmp_path / f"node{i + 1}"), servicer_kwargs)
            for i, k in enumerate(kinds)}

    def start(self):
        async def boot():
            for m in self.members.values():
                await m.start(dict(self.addresses))
        self.loop.run(boot())
        return self

    def leader(self, timeout=10.0):
        async def wait():
            while True:
                for m in self.members.values():
                    if m.alive and m.node.node.is_leader:
                        return m
                await asyncio.sleep(0.02)
        return self.loop.run(asyncio.wait_for(wait(), timeout), timeout + 5)

    def kill(self, nid):
        self.loop.run(self.members[nid].stop())

    def restart(self, nid):
        self.loop.run(self.members[nid].start(dict(self.addresses)))

    def transfer_to(self, nid, attempts=20):
        """Hand leadership to `nid` (retrying an aborted transfer)."""
        for _ in range(attempts):
            leader = self.leader()
            if leader.nid == nid:
                return leader
            try:
                self.loop.run(leader.node.node.transfer_leadership(nid))
            except Exception:  # aborted or raced: retry from the new view
                pass
        raise AssertionError(f"leadership never reached node {nid}")

    def converged(self, timeout=10.0):
        """Wait until every live member applied the same index with the
        same state digest; returns the members' states."""
        async def wait():
            while True:
                live = [m for m in self.members.values() if m.alive]
                applied = {m.node._last_applied_index for m in live}
                digests = {m.node.state.digest() for m in live}
                if len(applied) == 1 and len(digests) == 1:
                    return {m.nid: m.node.state.data for m in live}
                await asyncio.sleep(0.05)
        return self.loop.run(asyncio.wait_for(wait(), timeout), timeout + 5)

    def client(self, kind="port", **kw):
        kw.setdefault("discovery_backoff_s", 0.2)
        return PACKAGES[kind].LMSClient(list(self.addresses.values()), **kw)

    def close(self):
        async def stop():
            for m in self.members.values():
                await m.stop()
        try:
            self.loop.run(stop())
        finally:
            self.loop.close()


class GroupedMember:
    """One LMS node of a grouped deployment: an `LMSNode` per group, one
    inner servicer per group, the router on the LMS address (with group
    0's Raft and FileTransfer servicers), and a Raft-only server for each
    other group."""

    def __init__(self, pkg, nid, addresses, data_dir, secret):
        self.pkg, self.nid, self.addresses = pkg, nid, addresses
        self.data_dir, self.secret = data_dir, secret
        self.nodes, self.servers, self.router = {}, [], None
        self.metrics = None

    async def start(self):
        import os

        pkg = self.pkg
        groups = len(self.addresses)
        for gid in range(groups):
            extra = {} if gid == 0 else dict(
                blobs=self.nodes[0].blobs,
                blob_addresses=self.nodes[0].addresses,
                fault_prefix=f"raft:{gid}")
            self.nodes[gid] = pkg.LMSNode(
                self.nid, dict(self.addresses[gid]),
                self.data_dir if gid == 0
                else os.path.join(self.data_dir, f"group{gid}"),
                raft_config=pkg.RaftConfig(**FAST), **extra)
        inner = {gid: pkg.LMSServicer(
            n.node, n.state, self.nodes[0].blobs,
            peer_addresses=self.nodes[0].addresses, self_id=self.nid)
            for gid, n in self.nodes.items()}
        self.metrics = pkg.Metrics()
        self.router = pkg.router.RoutedLMSServicer(
            self.nodes, inner, self.nodes[0].addresses, self.nid,
            initial_map=pkg.router.RoutingMap.initial(groups),
            metrics=self.metrics, router_secret=self.secret)
        for gid, n in self.nodes.items():
            server = grpc.aio.server(options=[
                ("grpc.max_receive_message_length", 50 * 1024 * 1024)])
            if gid == 0:
                pkg.rpc.add_LMSServicer_to_server(self.router, server)
                pkg.rpc.add_FileTransferServiceServicer_to_server(
                    pkg.FileTransferServicer(n.blobs), server)
            pkg.rpc.add_RaftServiceServicer_to_server(
                pkg.RaftServicer(n.node, n.addresses,
                                 kv=n.state.data["kv"]), server)
            server.add_insecure_port(self.addresses[gid][self.nid])
            await server.start()
            self.servers.append(server)
        for n in self.nodes.values():
            await n.start()

    async def stop(self):
        if self.router is not None:
            await self.router.close()
        for n in self.nodes.values():
            if not n.node._stopped:
                await n.stop()
        for server in self.servers:
            await server.stop(None)


class GroupedCluster:
    """`groups` Raft groups over members of the given kinds, ids 1..N,
    behind one router secret."""

    def __init__(self, kinds, tmp_path, groups=2, secret="s3cret"):
        self.loop = LoopThread()
        n = len(kinds)
        addrs = free_addresses(n * groups)
        # group -> node id -> address; group 0's are the LMS addresses.
        self.group_addresses = {
            gid: {i + 1: addrs[gid * n + i] for i in range(n)}
            for gid in range(groups)}
        self.addresses = self.group_addresses[0]
        self.members = {
            i + 1: GroupedMember(
                PACKAGES[k], i + 1, self.group_addresses,
                str(tmp_path / f"node{i + 1}"), secret)
            for i, k in enumerate(kinds)}

    def start(self):
        async def boot():
            for m in self.members.values():
                await m.start()
        self.loop.run(boot())
        return self

    def leader(self, gid, timeout=10.0):
        async def wait():
            while True:
                for m in self.members.values():
                    if m.nodes[gid].node.is_leader:
                        return m
                await asyncio.sleep(0.02)
        return self.loop.run(asyncio.wait_for(wait(), timeout), timeout + 5)

    def transfer_to(self, gid, nid, attempts=20):
        """Hand group `gid`'s leadership to node `nid`."""
        for _ in range(attempts):
            leader = self.leader(gid)
            if leader.nid == nid:
                return leader
            try:
                self.loop.run(
                    leader.nodes[gid].node.transfer_leadership(nid))
            except Exception:  # aborted or raced: retry from the new view
                pass
        raise AssertionError(f"group {gid} never led by node {nid}")

    def converged(self, gid, timeout=10.0):
        """Wait until every member's replica of group `gid` applied the
        same index with the same state digest; (digest, state data)."""
        async def wait():
            while True:
                nodes = [m.nodes[gid] for m in self.members.values()]
                applied = {n._last_applied_index for n in nodes}
                digests = {n.state.digest() for n in nodes}
                if len(applied) == 1 and len(digests) == 1:
                    return digests.pop(), nodes[0].state.data
                await asyncio.sleep(0.05)
        return self.loop.run(asyncio.wait_for(wait(), timeout), timeout + 5)

    def client(self, kind="port", **kw):
        kw.setdefault("discovery_backoff_s", 0.2)
        return PACKAGES[kind].LMSClient(list(self.addresses.values()), **kw)

    def close(self):
        async def stop():
            for m in self.members.values():
                await m.stop()
        try:
            self.loop.run(stop())
        finally:
            self.loop.close()
