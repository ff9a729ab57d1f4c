"""Broker server binary: python -m dotaclient_tpu_torch.transport.tcp_server

Flags as the reference's binary. The one stdout line it prints once
listening names the bound port (`--port 0` picks a free one):
`broker listening on HOST:PORT (queue bound N[, shed H/L])`.
"""

from __future__ import annotations

import argparse
import time

from dotaclient_tpu_torch.transport.tcp import BrokerServer


def main(argv=None):
    p = argparse.ArgumentParser(description="dotaclient experience broker")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=13370)
    p.add_argument("--maxlen", type=int, default=4096, help="experience queue bound (drop-oldest)")
    p.add_argument("--shed_high", type=int, default=0,
                   help="refuse experience publishes from this queue depth (0 = admission control off)")
    p.add_argument("--shed_low", type=int, default=0,
                   help="admit again once the queue drains to this depth (must be < --shed_high)")
    args = p.parse_args(argv)
    server = BrokerServer(args.host, args.port, args.maxlen, shed_high=args.shed_high, shed_low=args.shed_low).start()
    shed = f", shed {args.shed_high}/{args.shed_low}" if args.shed_high else ""
    print(f"broker listening on {args.host}:{server.port} (queue bound {args.maxlen}{shed})", flush=True)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
