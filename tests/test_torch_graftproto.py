"""graftproto of the port (twin of tests/test_graftproto.py): SVC001–SVC004
over the port's fleet contract graph (analysis/fleetgraph.py).

- HEAD gate: the port's tree is SVC-clean with no SVC baseline entry —
  every route, clause meter, grammar literal and ledger term resolves
  against its producer among the port's binaries.
- Fixture corpus (tests/lint_fixtures_torch/): each SVC rule fires
  exactly on its labeled bad fixture and nowhere else.
- Mutants on a real-shaped tree: each drift class re-introduced into a
  COPY of the port's package and the manifests is caught.

SVC003 runs the port's real grammar parsers in their own subprocess
(analysis/grammar_check.py), so the lint interpreter keeps torch, numpy
and jax out; the proof is a subprocess test at the bottom.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys

import pytest

from dotaclient_tpu_torch.analysis import lint_repo
from dotaclient_tpu_torch.analysis.core import RULES

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "lint_fixtures_torch")
PKG = "dotaclient_tpu_torch"
BASELINE = os.path.join(REPO_ROOT, PKG, "analysis", "baseline.json")

SVC_RULES = ("SVC001", "SVC002", "SVC003", "SVC004")


def _svc(report):
    return [f for f in report.findings if f.rule.startswith("SVC")]


@functools.lru_cache(maxsize=None)
def _fixture_report():
    return lint_repo(FIXTURES)


# ---------------------------------------------------------------- repo gate


def test_repo_is_svc_clean_with_no_svc_baseline_entry():
    """SVC001–SVC004 pass on HEAD with NO SVC entry in the baseline: the
    fleet's contracts all hold on the port; nothing was grandfathered."""
    report = lint_repo(REPO_ROOT, rules=list(SVC_RULES))
    assert [f.render() for f in _svc(report)] == []
    with open(BASELINE) as f:
        entries = json.load(f)["entries"]
    assert not [fp for fp in entries if fp.startswith("SVC")]


def test_svc_rules_registered_as_errors():
    from dotaclient_tpu_torch.analysis import proto_rules  # noqa: F401 (registers)

    for rid in SVC_RULES:
        assert RULES[rid].severity == "error", rid


def test_grammar_check_bans_torch_and_the_jax_package():
    """The grammar subprocess reports torch, jax/jaxlib and the JAX
    package if they reach its interpreter, and the port's four parsers
    pull none of them."""
    from dotaclient_tpu_torch.analysis import grammar_check
    from dotaclient_tpu_torch.analysis.fleetgraph import GrammarLiteral
    from dotaclient_tpu_torch.analysis.proto_rules import _check_grammars

    assert set(grammar_check.BANNED) == {"torch", "jax", "jaxlib", "dotaclient_tpu"}
    result = _check_grammars(
        [
            GrammarLiteral("league_policy", "prioritized@0.7;exploiter@0.3", "k8s/x.yaml", 1),
            GrammarLiteral("fleet_alerts", "fleet_fixture_ok,gt", "k8s/x.yaml", 2),
        ]
    )
    assert result["banned_imports"] == []
    assert [f["line"] for f in result["failures"]] == [2]


# ------------------------------------------------------------ fixture corpus


def test_fixture_corpus_fires_each_svc_rule_exactly_where_labeled():
    report = _fixture_report()
    svc = {}
    for f in _svc(report):
        svc.setdefault(f.rule, []).append(f)
    assert set(svc) == set(SVC_RULES)

    svc1 = sorted(svc["SVC001"], key=lambda f: f.path)
    assert [os.path.basename(f.path) for f in svc1] == ["fleetd.py", "fleetd-fixture.yaml"]
    assert "'/topologyy'" in svc1[0].message  # the drifted code edge
    assert "dotaclient_tpu_torch.control.server" in svc1[0].message
    assert "'/fleet/status'" in svc1[1].message  # the drifted probe

    (f2,) = svc["SVC002"]
    assert os.path.basename(f2.path) == "control-fixture.yaml"
    assert "'serve_ghost_occupancy'" in f2.message

    (f3,) = svc["SVC003"]
    assert os.path.basename(f3.path) == "fleetd-fixture.yaml"
    assert "fleet_alerts" in f3.message

    (f4,) = svc["SVC004"]
    assert f4.path == f"{PKG}/obs/fleet.py"
    assert "'fleet_ghost_dropped_total'" in f4.message
    assert f4.context == "LEDGERS"


def test_obs001_prefix_families_cover_fstring_heads():
    report = _fixture_report()
    obs1 = [f for f in report.findings if f.rule == "OBS001" and "obs_emitters" in f.path]
    dynamic = [f for f in obs1 if "dynamically-composed" in f.message]
    assert len(dynamic) == 1
    assert "'rogue_fam_…'" in dynamic[0].message
    assert "bad_fstring_window" in dynamic[0].context
    assert not any("good_fstring_window" in f.context for f in obs1)


# ----------------------------------------------- suppression + baseline


def test_svc_finding_obeys_inline_suppression_discipline(tmp_path):
    corpus = tmp_path / "corpus"
    shutil.copytree(FIXTURES, corpus)
    fleetd = corpus / PKG / "obs" / "fleetd.py"
    fleetd.write_text(
        fleetd.read_text().replace(
            'urlopen(f"http://{self._control_endpoint}/topologyy")',
            'urlopen(f"http://{self._control_endpoint}/topologyy")'
            "  # graftlint: disable=SVC001(fixture: drift kept on purpose)",
        )
    )
    report = lint_repo(str(corpus))
    assert not any(f.rule == "SVC001" and f.path.endswith("fleetd.py") for f in report.findings)
    assert any(f.rule == "SVC001" and f.path.endswith("fleetd.py") for f in report.suppressed)


def test_svc_finding_baselines_and_goes_stale(tmp_path):
    report = _fixture_report()
    pinned = next(f for f in _svc(report) if f.rule == "SVC004")
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"entries": {pinned.fingerprint(): {"reason": "audited"}}}))
    pinned_run = lint_repo(FIXTURES, baseline_path=str(bl))
    assert pinned.fingerprint() in {f.fingerprint() for f in pinned_run.baselined}
    assert pinned.fingerprint() not in {f.fingerprint() for f in pinned_run.findings}

    corpus = tmp_path / "corpus"
    shutil.copytree(FIXTURES, corpus)
    fp = corpus / PKG / "obs" / "fleet.py"
    src = fp.read_text()
    fixed = src.replace('            LedgerTerm("fleet_ghost_dropped_total", "actor", -1.0),\n', "")
    assert fixed != src, "fixture ledger term moved — update this pin"
    fp.write_text(fixed)
    after = lint_repo(str(corpus), baseline_path=str(bl))
    assert pinned.fingerprint() in after.stale_baseline


def test_svc_fingerprints_survive_line_shifts(tmp_path):
    corpus = tmp_path / "corpus"
    shutil.copytree(FIXTURES, corpus)
    before = {f.fingerprint() for f in _svc(lint_repo(str(corpus), rules=list(SVC_RULES)))}
    fp = corpus / PKG / "obs" / "fleet.py"
    fp.write_text("# pad\n# pad\n# pad\n" + fp.read_text())
    after = {f.fingerprint() for f in _svc(lint_repo(str(corpus), rules=list(SVC_RULES)))}
    assert before == after


# --------------------------------------------------- mutants on a real tree


def _package_copy(tmp_path):
    shutil.copytree(
        os.path.join(REPO_ROOT, PKG), tmp_path / PKG, ignore=shutil.ignore_patterns("__pycache__")
    )
    shutil.copytree(os.path.join(REPO_ROOT, "k8s"), tmp_path / "k8s")
    return tmp_path


def _mutated_lint(tmp_path, rel: str, old: str, new: str, rule: str, count: int = -1):
    root = _package_copy(tmp_path)
    path = root / rel
    src = path.read_text()
    mutant = src.replace(old, new, count)
    assert mutant != src, f"{rel}: the mutant's pin moved — update it"
    path.write_text(mutant)
    return [f for f in lint_repo(str(root), rules=[rule]).findings if f.rule == rule]


def test_policy_meter_rename_regression_fails_lint(tmp_path):
    """control.yaml keyed broker scaling on fabric_queue_depth once, a
    meter no tier exports; against the port's binaries SVC002 names it."""
    svc2 = _mutated_lint(
        tmp_path, "k8s/control.yaml", "broker:broker_shard_depth.max", "broker:fabric_queue_depth.max", "SVC002"
    )
    assert svc2 and any("fabric_queue_depth" in f.message for f in svc2)


def test_probe_path_drift_mutant_fails_lint(tmp_path):
    svc1 = _mutated_lint(tmp_path, "k8s/inference.yaml", "path: /healthz", "path: /healthzz", "SVC001")
    assert svc1 and all("'/healthzz'" in f.message for f in svc1)
    assert any("inference.yaml" in f.path for f in svc1)


def test_grammar_typo_mutant_fails_lint(tmp_path):
    """A truncated matchmaking clause crashes the league binary at boot;
    SVC003 runs the port's real parse_match_policy on the literal."""
    svc3 = _mutated_lint(
        tmp_path, "k8s/league.yaml", '"prioritized@0.7;exploiter@0.3"', '"prioritized@0.7;exploiter@"', "SVC003"
    )
    assert svc3 and any("league_policy" in f.message and "league.yaml" in f.path for f in svc3)


def test_ledger_term_rename_mutant_fails_lint(tmp_path):
    svc4 = _mutated_lint(
        tmp_path,
        f"{PKG}/obs/fleet.py",
        'LedgerTerm("actor_rollouts_published_total", "actor"',
        'LedgerTerm("actor_rollouts_published_totalz", "actor"',
        "SVC004",
    )
    assert svc4 and any("actor_rollouts_published_totalz" in f.message for f in svc4)


def test_unextractable_ledgers_is_loud_not_silent(tmp_path):
    svc4 = _mutated_lint(
        tmp_path,
        f"{PKG}/obs/fleet.py",
        "LEDGERS: Tuple[LedgerSpec, ...] = (",
        "LEDGERS: Tuple[LedgerSpec, ...] = 1 * (",
        "SVC004",
        count=1,
    )
    assert svc4 and any("extraction failed" in f.message for f in svc4)


def test_route_rename_on_the_serving_side_fails_lint(tmp_path):
    """Renaming a route where the port's control plane registers it
    leaves every dialer 404ing: SVC001 names the dialed route."""
    root = _package_copy(tmp_path)
    served = [
        p for p in (root / PKG / "control").glob("*.py") if '"/topology"' in p.read_text()
    ]
    assert served, "the control plane's /topology registration moved — update this pin"
    for p in served:
        p.write_text(p.read_text().replace('"/topology"', '"/topology2"'))
    svc1 = [f for f in lint_repo(str(root), rules=["SVC001"]).findings if f.rule == "SVC001"]
    assert any("'/topology'" in f.message for f in svc1), [f.render() for f in svc1]


def test_corpus_without_fleet_surfaces_skips_cleanly(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "mod.py").write_text(
        "from urllib.request import urlopen\n"
        "def poll(ep):\n"
        "    return urlopen(f'http://{ep}/some/route')\n"
    )
    assert _svc(lint_repo(str(tmp_path))) == []


# ------------------------------------------------------------- import proof


def test_svc_rules_run_without_torch_numpy_or_jax_in_lint_process():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        "from dotaclient_tpu_torch.analysis import lint_repo\n"
        f"report = lint_repo({REPO_ROOT!r}, rules={list(SVC_RULES)!r})\n"
        "assert not report.failures(), report.failures()\n"
        "for mod in ('torch', 'numpy', 'jax', 'dotaclient_tpu'):\n"
        "    assert mod not in sys.modules, 'SVC linting imported ' + mod\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=180)


# ------------------------------------------------------------- nightly lane


@pytest.mark.nightly
@pytest.mark.slow
def test_lint_strict_nightly_covers_svc_and_reports_budget():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.scripts.lint_graft", "--strict", "--json"],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=REPO_ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout.strip().splitlines()[-1])
    assert payload["ok"]
    assert set(SVC_RULES) <= set(payload["rule_seconds"])
    assert all(s >= 0.0 for s in payload["rule_seconds"].values())
