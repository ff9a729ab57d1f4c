"""SVC003 subprocess: parse config-grammar literals with the REAL
parsers, import-isolated from the lint.

The graftlint process must never import the package (the no-import
proof in tests/test_torch_graftlint.py asserts it) — but SVC003's whole
point is that a grammar literal must parse with the parser that will
read it at boot, not with a lint-side reimplementation that could
drift. So the rule ships each literal here, in a fresh interpreter, and
this runner imports exactly the port's four stdlib-only parser modules.
It also reports any torch, jax, jaxlib or reference-package
(``dotaclient_tpu``) module that sneaks into sys.modules: a parser
module growing an accelerator import, or an import of the JAX package,
is itself a contract break (the control/league/fleet tiers are
documented torch-free), surfaced as a finding rather than a mysterious
cold-start regression. numpy is deliberately NOT banned here —
importing league.policy runs league/__init__, whose registry is
numpy-for-snapshot-trees by contract; the LINT process itself still
bans it (tests/test_torch_graftlint.py's subprocess proof).

stdin:  {"root": <repo root>, "items": [{"grammar","text","path","line"}]}
stdout: {"failures": [{"path","line","grammar","error"}],
         "banned_imports": ["torch", ...]}

Grammar ids → parsers:
    control_policy → dotaclient_tpu_torch.control.policy.parse_policy
    fleet_alerts   → dotaclient_tpu_torch.obs.fleet.parse_alerts
    league_policy  → dotaclient_tpu_torch.league.policy.parse_match_policy
    chaos_spec     → dotaclient_tpu_torch.chaos.schedule.FaultSchedule.parse
"""

from __future__ import annotations

import json
import sys

BANNED = ("torch", "jax", "jaxlib", "dotaclient_tpu")


def _parsers():
    from dotaclient_tpu_torch.chaos.schedule import FaultSchedule
    from dotaclient_tpu_torch.control.policy import parse_policy
    from dotaclient_tpu_torch.league.policy import parse_match_policy
    from dotaclient_tpu_torch.obs.fleet import parse_alerts

    return {
        "control_policy": parse_policy,
        "fleet_alerts": parse_alerts,
        "league_policy": parse_match_policy,
        "chaos_spec": lambda spec: FaultSchedule.parse(spec, seed=0),
    }


def _banned() -> list:
    return sorted(set(BANNED) & set(sys.modules))


def main() -> int:
    payload = json.load(sys.stdin)
    sys.path.insert(0, payload["root"])
    failures = []
    try:
        parsers = _parsers()
    except Exception as e:  # import failure IS the finding
        json.dump(
            {
                "failures": [
                    {
                        "path": item["path"],
                        "line": item["line"],
                        "grammar": item["grammar"],
                        "error": f"parser import failed: {e!r}",
                    }
                    for item in payload["items"]
                ],
                "banned_imports": _banned(),
            },
            sys.stdout,
        )
        return 0
    for item in payload["items"]:
        parser = parsers.get(item["grammar"])
        if parser is None:
            continue
        try:
            parser(item["text"])
        except Exception as e:
            failures.append(
                {
                    "path": item["path"],
                    "line": item["line"],
                    "grammar": item["grammar"],
                    "error": f"{type(e).__name__}: {e}",
                }
            )
    json.dump({"failures": failures, "banned_imports": _banned()}, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
