"""The inference service (torch twin of dotaclient_tpu/serve/):

- serve/wire.py    the framed request/response protocol, byte for byte
                   the reference's;
- serve/server.py  InferenceServer: continuous batching, resident LSTM
                   carries on the serving device, weight hot-swap;
                   `python -m dotaclient_tpu_torch.serve.server`;
- serve/handoff.py the carry store behind session continuity;
- serve/client.py  the actors' side: RemotePolicyClient (failover,
                   load routing, resume), RemoteActor, RemoteFleet and
                   the local fallback.
"""

from __future__ import annotations

__all__ = ["InferenceServer"]


def __getattr__(name):
    # lazy: importing the package for the wire module must not build a server
    if name == "InferenceServer":
        from dotaclient_tpu_torch.serve.server import InferenceServer

        return InferenceServer
    raise AttributeError(name)
