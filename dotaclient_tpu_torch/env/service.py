"""The DotaService API (own copy of dotaclient_tpu/env/service.py): the
servicer surface, an in-process stub, and gRPC plumbing for a network
env address.

The actor path imports no `grpc`: an in-process env (the fake env behind
`LocalDotaServiceStub`) needs none, and the functions that dial or serve a
network address import it inside themselves. Without `grpc` those fail at
once with an error that names it. On the wire the calls are the
reference's (`/dotaclient_tpu.DotaService/<method>`, unary-unary, the
messages' proto3 bytes through the port's own codec), so either package's
client talks to either package's server. A gRPC failure reaches the
caller as `EnvRpcError`, which keeps the status code; the actor retries it.
"""

from __future__ import annotations

from typing import Optional

from dotaclient_tpu_torch.protos import dotaservice as ds

SERVICE_NAME = "dotaclient_tpu.DotaService"

_METHODS = {
    # name: (request class, response class)
    "reset": (ds.GameConfig, ds.Observation),
    "observe": (ds.ObserveRequest, ds.Observation),
    "act": (ds.Actions, ds.Empty),
}


class EnvRpcError(RuntimeError):
    """An env RPC failed (server down, restarted, deadline): the gRPC
    error the network stub caught, with its status `code()` and
    `details()`."""

    def __init__(self, method: str, cause):
        self._code = cause.code() if hasattr(cause, "code") else None
        self._details = cause.details() if hasattr(cause, "details") else str(cause)
        super().__init__(f"{method}: {self._code}: {self._details}")

    def code(self):
        return self._code

    def details(self):
        return self._details


class DotaServiceServicer:
    """Subclass and override; the reference's servicer surface."""

    def reset(self, request: ds.GameConfig, context) -> ds.Observation:
        raise NotImplementedError

    def observe(self, request: ds.ObserveRequest, context) -> ds.Observation:
        raise NotImplementedError

    def act(self, request: ds.Actions, context) -> ds.Empty:
        raise NotImplementedError


class _LocalContext:
    """Stands in for grpc's ServicerContext in-process; the fake env keys
    sessions by peer()."""

    def __init__(self, name: str):
        self._name = name

    def peer(self) -> str:
        return self._name


class _ClosableNone:
    async def close(self) -> None:  # a channel's teardown, for reset_env_stub
        pass


class LocalDotaServiceStub:
    """In-process stub: the async surface of the network stub, no gRPC.
    Each stub gets its own peer name, so the fake env gives it a private
    session, as it would a distinct network client. Messages pass as
    objects, never as bytes."""

    _n = 0

    def __init__(self, servicer: DotaServiceServicer, name: Optional[str] = None):
        LocalDotaServiceStub._n += 1
        self._servicer = servicer
        self._ctx = _LocalContext(name or f"local-{LocalDotaServiceStub._n}")
        self.channel = _ClosableNone()

    async def reset(self, request):
        return self._servicer.reset(request, self._ctx)

    async def observe(self, request):
        return self._servicer.observe(request, self._ctx)

    async def act(self, request):
        return self._servicer.act(request, self._ctx)


# ----------------------------------------------------------------- gRPC


def _grpc():
    try:
        import grpc
    except ImportError as e:
        raise RuntimeError(
            "a network env address needs the grpc package, which is not installed; an in-process env "
            "(LocalDotaServiceStub on the fake env) needs none"
        ) from e
    return grpc


def require_grpc() -> None:
    """Raise now, naming grpc, when a network env cannot be reached."""
    _grpc()


class DotaServiceStub:
    """Blocking client over a grpc channel (tests, tools): each method
    sends its request and returns the reply, raising EnvRpcError."""

    def __init__(self, channel, rpc_error):
        self.channel = channel
        self._rpc_error = rpc_error
        for name, (req, resp) in _METHODS.items():
            call = channel.unary_unary(f"/{SERVICE_NAME}/{name}", request_serializer=req.SerializeToString,
                                       response_deserializer=resp.FromString)
            setattr(self, name, self._wrap(name, call))

    def _wrap(self, name, call):
        def method(request, **kw):
            try:
                return call(request, **kw)
            except self._rpc_error as e:
                raise EnvRpcError(name, e) from e

        return method


class AsyncDotaServiceStub(DotaServiceStub):
    """The actor's client over a grpc.aio channel: each method is a
    coroutine, raising EnvRpcError."""

    def _wrap(self, name, call):
        async def method(request, **kw):
            try:
                return await call(request, **kw)
            except self._rpc_error as e:
                raise EnvRpcError(name, e) from e

        return method


_uid = 0


def _unique_options():
    """gRPC fuses channels to one target onto one TCP connection; a
    distinct channel arg gives each client its own, so the server sees a
    peer per client (the fake env keys sessions by peer)."""
    global _uid
    _uid += 1
    return [("dotaclient.channel_uid", _uid)]


def connect(addr: str) -> DotaServiceStub:
    grpc = _grpc()
    return DotaServiceStub(grpc.insecure_channel(addr, options=_unique_options()), grpc.RpcError)


def connect_async(addr: str) -> AsyncDotaServiceStub:
    """Call inside the running event loop: an aio channel binds to it."""
    grpc = _grpc()
    return AsyncDotaServiceStub(grpc.aio.insecure_channel(addr, options=_unique_options()), grpc.RpcError)


def serve(servicer: DotaServiceServicer, port: int = 0, max_workers: int = 4):
    """Start an insecure server on 127.0.0.1; returns (server, bound port)."""
    from concurrent import futures

    grpc = _grpc()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
        for name, (req, resp) in _METHODS.items()
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server, bound
