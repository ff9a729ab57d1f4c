"""The inference service (torch twin of dotaclient_tpu/serve/):

- serve/wire.py    the framed request/response protocol, byte for byte
                   the reference's;
- serve/server.py  InferenceServer: continuous batching, resident LSTM
                   carries on the serving device, weight hot-swap;
                   `python -m dotaclient_tpu_torch.serve.server`.

The reference's clients (serve/client.py) need grpc for their episode
loop and are not ported (ROADMAP A.11); its carry store (serve/handoff.py)
is ROADMAP A.12b.
"""

from __future__ import annotations

__all__ = ["InferenceServer"]


def __getattr__(name):
    # lazy: importing the package for the wire module must not build a server
    if name == "InferenceServer":
        from dotaclient_tpu_torch.serve.server import InferenceServer

        return InferenceServer
    raise AttributeError(name)
