"""Host preflight for measuring scripts (own copy of
dotaclient_tpu/obs/preflight.py): stray-process detection + disclosure.

A serve server or broker left over from an earlier run silently eats the
cores a measurement computes on. A measuring script calls `check()` before
it measures: it scans for listening TCP sockets owned by other processes of
either package (any cmdline naming `dotaclient_tpu`, which
`dotaclient_tpu_torch` contains) and any explicitly named ports, fails
loudly with the pid + cmdline, and returns a host-state disclosure dict
the script prints or embeds beside its numbers.

Stdlib + /proc only: where /proc is missing the scan degrades to an empty
disclosure, never a crash. DOTACLIENT_TPU_ALLOW_STRAYS=1 downgrades the
failure to a disclosed warning for deliberately co-located runs.
"""

from __future__ import annotations

import os
import platform
import sys
import time
from typing import Dict, Iterable, List

# Processes whose cmdline contains any of these are "ours": a stray
# broker/serve/learner from an earlier run competes for the measured cores.
_REPO_MARKERS = ("dotaclient_tpu",)
_LISTEN_STATE = "0A"  # /proc/net/tcp st column, TCP_LISTEN


def _listening_inodes() -> Dict[str, int]:
    """socket-inode → local port for every LISTEN tcp/tcp6 socket."""
    out: Dict[str, int] = {}
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(path) as f:
                lines = f.readlines()[1:]
        except OSError:
            continue
        for line in lines:
            cols = line.split()
            if len(cols) < 10 or cols[3] != _LISTEN_STATE:
                continue
            try:
                port = int(cols[1].rsplit(":", 1)[1], 16)
            except (ValueError, IndexError):
                continue
            out[cols[9]] = port
    return out


def _pid_sockets(pid: str) -> List[str]:
    """Socket inodes held by `pid` (empty on permission/vanished)."""
    inodes = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("socket:["):
                inodes.append(target[8:-1])
    except OSError:
        pass
    return inodes


def _cmdline(pid: str) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\x00", b" ").decode(errors="replace").strip()
    except OSError:
        return ""


def _ancestors() -> set:
    """This process and its ancestry — a pytest or script parent holding a
    metrics port must not read as a stray of its own child run."""
    pids = set()
    pid = os.getpid()
    for _ in range(32):  # bounded walk; /proc chains are short
        pids.add(pid)
        try:
            with open(f"/proc/{pid}/status") as f:
                ppid = next(
                    (int(l.split()[1]) for l in f if l.startswith("PPid:")), 0
                )
        except (OSError, ValueError):
            break
        if ppid <= 1:
            pids.add(ppid)
            break
        pid = ppid
    return pids


def scan_listeners(ports: Iterable[int] = ()) -> List[dict]:
    """Listening sockets that would contaminate a measurement: any
    OTHER process of this package holding a LISTEN socket, plus ANY
    process listening on an explicitly named port. Each entry carries
    the pid, port, and cmdline — the fail-loudly payload."""
    ports = set(int(p) for p in ports)
    inode_port = _listening_inodes()
    if not inode_port:
        return []
    own = _ancestors()
    strays = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) in own:
            continue
        held = [i for i in _pid_sockets(pid) if i in inode_port]
        if not held:
            continue
        cmd = _cmdline(pid)
        repo_proc = any(m in cmd for m in _REPO_MARKERS)
        for inode in held:
            port = inode_port[inode]
            if repo_proc or port in ports:
                strays.append({"pid": int(pid), "port": port, "cmdline": cmd[:200]})
    return sorted(strays, key=lambda s: (s["port"], s["pid"]))


def host_disclosure() -> dict:
    """The host-state block a script prints beside its numbers: enough to
    judge whether a number came from a quiet host."""
    try:
        load1, load5, _ = os.getloadavg()
    except OSError:
        load1 = load5 = -1.0
    return {
        "cpus": os.cpu_count(),
        "loadavg_1m": round(load1, 2),
        "loadavg_5m": round(load5, 2),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "checked_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def check(label: str, ports: Iterable[int] = ()) -> dict:
    """Preflight before a measurement: scan for strays and FAIL LOUDLY
    (SystemExit naming every pid/port/cmdline) if any are found — a
    measurement on a contaminated host is worse than no measurement.
    Returns the disclosure dict (host state + the stray scan result) for
    the script's output. DOTACLIENT_TPU_ALLOW_STRAYS=1 downgrades to a
    stderr warning with the strays still disclosed in the artifact."""
    strays = scan_listeners(ports)
    out = host_disclosure()
    out["preflight"] = {
        "label": label,
        "ports_checked": sorted(int(p) for p in ports),
        "strays": strays,
        "ok": not strays,
    }
    if strays:
        lines = "\n".join(
            f"  pid {s['pid']} listening on :{s['port']} — {s['cmdline']}"
            for s in strays
        )
        msg = (
            f"[{label}] preflight: {len(strays)} stray already-listening "
            f"process(es) would contaminate this measurement:\n{lines}\n"
            f"Kill them (or set DOTACLIENT_TPU_ALLOW_STRAYS=1 to proceed "
            f"with the contamination disclosed in the artifact)."
        )
        if os.environ.get("DOTACLIENT_TPU_ALLOW_STRAYS", "") not in ("", "0"):
            print(f"WARNING: {msg}", file=sys.stderr)
        else:
            raise SystemExit(msg)
    return out
