"""Graftlint of the port (twin of tests/test_graftlint.py): the port's
tree stays clean, its fixture corpus (tests/lint_fixtures_torch/) stays
detected, its baseline stays honest, and the reference's lint and the
port's report the same rules at the same lines on twin corpora. All pure
AST: no torch, no JAX work in the lint itself.

Left out of the reference's file: the JAX-rule cases (the port has no
jit region and registers no JAX rule), i.e. the jax_bad.py/jax_good.py
fixtures, test_positional_nonfunction_jit_arg_mints_no_region and
test_eager_call_to_raw_wrapped_fn_is_not_jax003. The nightly --strict
lane stays nightly (and slow).
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from dotaclient_tpu.analysis import lint_repo as ref_lint_repo
from dotaclient_tpu_torch.analysis import lint_repo, load_baseline
from dotaclient_tpu_torch.analysis.core import RULES

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "lint_fixtures_torch")
REF_FIXTURES = os.path.join(REPO_ROOT, "tests", "lint_fixtures")
PKG = "dotaclient_tpu_torch"
BASELINE = os.path.join(REPO_ROOT, PKG, "analysis", "baseline.json")
LINT_SCRIPT = os.path.join(REPO_ROOT, PKG, "scripts", "lint_graft.py")
PORT_RULES = {
    "THR001",
    "THR002",
    "OBS001",
    "OBS002",
    "OBS003",
    "LIF001",
    "LIF002",
    "WIRE001",
    "SVC001",
    "SVC002",
    "SVC003",
    "SVC004",
}


@functools.lru_cache(maxsize=None)
def _repo_report():
    """One full lint of the tree per process (the two gate tests read
    the same report; a lint of the port costs ~10 s)."""
    return lint_repo(REPO_ROOT)


@functools.lru_cache(maxsize=None)
def _fixture_report():
    return lint_repo(FIXTURES)


# ---------------------------------------------------------------- repo gate


def test_repo_lints_clean():
    """The gate in-process: no new errors, no stale baseline, no
    reason-less suppressions anywhere in the port's package."""
    report = _repo_report()
    assert report.files_scanned > 50  # the whole package, not a subdir
    assert report.failures(strict=False) == []


def test_repo_lints_clean_under_strict():
    report = _repo_report()
    assert report.failures(strict=True) == []


def test_lint_script_runs_without_torch_numpy_or_jax(tmp_path):
    """The lint must work with no torch, numpy or JAX import and with
    nothing of the JAX package: the suite's conftest imports jax, so the
    proof runs in a subprocess."""
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO_ROOT!r})
        from dotaclient_tpu_torch.analysis import lint_repo
        report = lint_repo({REPO_ROOT!r})
        assert not report.failures(), report.failures()
        for mod in ("torch", "numpy", "jax", "jaxlib", "dotaclient_tpu"):
            assert mod not in sys.modules, "linting imported " + mod
        """
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=180)


# ------------------------------------------------------------ fixture corpus


def test_every_rule_fires_on_the_bad_corpus():
    report = _fixture_report()
    fired = {f.rule for f in report.findings}
    assert PORT_RULES <= fired, f"rules that never fired: {PORT_RULES - fired}"
    # every registered rule is exercised by the corpus, and no JAX rule
    # is registered
    assert PORT_RULES == set(RULES), "corpus out of sync with the rule registry"


def test_good_corpus_is_clean():
    report = _fixture_report()
    noisy = [f.render() for f in report.findings if "good" in os.path.basename(f.path)]
    assert noisy == [], noisy


def test_suppression_without_reason_is_itself_an_error():
    report = _fixture_report()
    assert any(f.rule == "GRAFT000" and "thr_bad" in f.path for f in report.invalid)
    # and it did NOT suppress the underlying finding
    assert any(f.rule == "THR001" and "total_suppressed_badly" in f.context for f in report.findings)


def test_suppression_syntax_in_docstring_is_not_parsed():
    from dotaclient_tpu_torch.analysis.core import Suppressions

    src = (
        '"""Docs: a bare graftlint: disable=THR001 does not suppress."""\n'
        'msg = "see # graftlint: disable=LIF001 in the README"\n'
        "x = 1  # graftlint: disable=OBS001(a real comment suppression)\n"
    )
    sup = Suppressions(src)
    assert sup.missing_reason == []
    assert not sup.covers("THR001", 1)
    assert not sup.covers("LIF001", 2)
    assert sup.covers("OBS001", 3)


def test_specific_known_bad_lines():
    """Findings land on the labeled lines, not just somewhere in the file."""
    report = _fixture_report()
    by_rule = {}
    for f in report.findings:
        by_rule.setdefault((f.rule, os.path.basename(f.path)), []).append(f)
    thr002 = by_rule[("THR002", "thr_bad.py")]
    # two distinct cycles, each reported once: the reversed pair and the
    # 3-lock A→B→C→A cycle in which no single pair is ever reversed
    assert len(thr002) == 2
    assert any("ThreeLockCycle" in f.context for f in thr002)
    assert any("LostUpdateCounter" in f.context for f in by_rule[("THR001", "thr_bad.py")])
    obs002 = by_rule[("OBS002", "learner-fixture.yaml")]
    # the manifest names the reference's binary; the port lints it as its
    # twin's namespace: the unknown arg and the env-nested flag fire, the
    # sidecar's flags do not
    flagged = {f.message.split(" ", 1)[0] for f in obs002}
    assert flagged == {"--no_such_flag", "--bogus_env_flag"}, obs002
    assert all("dotaclient_tpu_torch.runtime.learner" in f.message for f in obs002)
    obs002_s = by_rule[("OBS002", "spawn_fixture.py")]
    assert {f.message.split(" ", 1)[0] for f in obs002_s} == {"--not_a_learner_flag"}, obs002_s
    # LIF001: the four packer shapes, and the copy-event shapes: released
    # at dispatch, fenced on another event, a reaper with no query, a
    # teardown with no event at all
    lif001 = {f.context for f in by_rule[("LIF001", "lif_bad.py")]}
    assert lif001 == {
        "LeakyPacker.pack_leak",
        "LeakyPacker.pack_raise_leak",
        "LeakyPacker.pack_double_release",
        "DoubleBufferPacker.pack_pair",
        "EarlyReleaseFetcher.fetch",
        "WrongFenceFetcher.fetch",
        "EagerReaper.reap",
        "EagerReaper.release_all",
    }, lif001
    lif002 = by_rule[("LIF002", "lif_bad.py")]
    assert any("self._side" in f.message for f in lif002)
    assert any("in-flight flag" in f.message for f in lif002)
    # WIRE001: the fixture csrc/packer.cc deliberately drifts kWireBf16
    wire = by_rule[("WIRE001", "packer.cc")]
    assert any("wire code bf16: 3 (py) vs 4 (cc)" in f.message for f in wire)
    assert all(f.path == f"{PKG}/csrc/packer.cc" for f in wire)


def test_bad_snippet_introduced_into_package_fails(tmp_path):
    """Copy a known-bad fixture into a package tree and the entry point
    exits 1, naming the new violation."""
    pkg = tmp_path / PKG
    pkg.mkdir()
    shutil.copy(os.path.join(FIXTURES, PKG, "thr_bad.py"), pkg / "sneaky.py")
    proc = subprocess.run(
        [sys.executable, LINT_SCRIPT, "--root", str(tmp_path), "--json", str(pkg)],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not payload["ok"]
    assert any("THR001" in line for line in payload["new"])


def test_subset_lint_keeps_repo_rules_honest():
    """An explicit paths subset still analyzes the whole package for the
    cross-file rules and restricts only the REPORT to the files asked."""
    target = os.path.join(REPO_ROOT, PKG, "obs", "http.py")
    report = lint_repo(REPO_ROOT, paths=[target])
    assert report.files_scanned == 1
    assert report.failures(strict=True) == []


# ---------------------------------------------------------------- baseline


def test_baseline_entries_all_carry_reasons():
    reasons, errors = load_baseline(BASELINE)
    assert errors == []
    assert all(r.strip() for r in reasons.values())


def test_baseline_pins_only_audited_findings():
    """Every entry of the port's baseline pins a finding that exists on
    the tree (none stale) and has its own reason — not the placeholder a
    regeneration writes."""
    reasons, _ = load_baseline(BASELINE)
    report = _repo_report()
    assert report.stale_baseline == []
    assert {f.fingerprint() for f in report.baselined} == set(reasons)
    assert len(set(reasons.values())) == len(reasons)


def test_write_baseline_pins_warnings_for_strict(tmp_path):
    """--write-baseline pins warning-severity findings too, or the
    --strict lane stays red after the regenerate-and-audit workflow."""
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "config.py").write_text(
        textwrap.dedent(
            """
            from dataclasses import dataclass

            @dataclass
            class MiniConfig:
                never_read_anywhere: int = 0
            """
        )
    )
    base = [sys.executable, LINT_SCRIPT, "--root", str(tmp_path)]
    run = lambda extra: subprocess.run(base + extra, capture_output=True, text=True, timeout=120)  # noqa: E731
    assert run(["--strict"]).returncode == 1  # the OBS003 warning
    assert run(["--write-baseline", "pin for test"]).returncode == 0
    assert os.path.exists(tmp_path / PKG / "analysis" / "baseline.json")
    proc = run(["--strict"])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fingerprints_survive_line_shifts(tmp_path):
    src = open(os.path.join(FIXTURES, PKG, "thr_bad.py")).read()
    before = _lint_source(tmp_path, src)
    shutil.rmtree(tmp_path / PKG)
    after = _lint_source(tmp_path, "# pad\n# pad\n# pad\n" + src)
    fp = lambda r: sorted(f.fingerprint() for f in r.findings)  # noqa: E731
    assert fp(before) == fp(after)


def test_stale_baseline_entry_fails(tmp_path):
    fake = tmp_path / "baseline.json"
    fake.write_text(
        json.dumps({"entries": {f"THR001:{PKG}/gone.py:Gone.reader:deadbeef00": {"reason": "was real once"}}})
    )
    report = lint_repo(REPO_ROOT, baseline_path=str(fake))
    assert report.stale_baseline, "stale entry not detected"
    assert any("stale" in msg for msg in report.failures())


def test_rule_subset_judges_only_its_own_baseline_entries(tmp_path):
    """A lint of a rule subset cannot call another rule's baseline entry
    stale (it did not look for that finding); an entry of a rule that ran
    and found nothing is stale as ever."""
    fake = tmp_path / "baseline.json"
    fake.write_text(
        json.dumps(
            {
                "entries": {
                    f"THR001:{PKG}/gone.py:Gone.reader:deadbeef00": {"reason": "was real once"},
                    f"OBS003:{PKG}/gone.py:Gone:deadbeef01": {"reason": "was real once"},
                }
            }
        )
    )
    report = lint_repo(FIXTURES, baseline_path=str(fake), rules=["OBS003"])
    assert report.stale_baseline == [f"OBS003:{PKG}/gone.py:Gone:deadbeef01"]


def test_baseline_pins_findings(tmp_path):
    report = _fixture_report()
    pinned = next(f for f in report.findings if f.rule == "THR001")
    fake = tmp_path / "baseline.json"
    fake.write_text(json.dumps({"entries": {pinned.fingerprint(): {"reason": "pinned for test"}}}))
    repinned = lint_repo(FIXTURES, baseline_path=str(fake))
    assert pinned.fingerprint() not in {f.fingerprint() for f in repinned.findings}
    assert any(f.fingerprint() == pinned.fingerprint() for f in repinned.baselined)


def test_baselined_finding_gaining_suppression_is_not_stale(tmp_path):
    corpus = tmp_path / "corpus"
    pkg = corpus / PKG
    pkg.mkdir(parents=True)
    src = (
        "import threading\n"
        "\n"
        "\n"
        "class Torn:\n"
        "    def __init__(self):\n"
        "        self._latest = None\n"
        "        self._t = None\n"
        "\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self._run)\n"
        "\n"
        "    def _run(self):\n"
        "        self._latest = (0, {})\n"
        "\n"
        "    def latest(self):\n"
        "        if self._latest is not None:\n"
        "            return self._latest[1]\n"
        "        return {}\n"
    )
    (pkg / "mod.py").write_text(src)
    first = lint_repo(str(corpus), paths=[str(pkg)])
    pinned = next(f for f in first.findings if f.rule == "THR001")
    fake = tmp_path / "baseline.json"
    fake.write_text(json.dumps({"entries": {pinned.fingerprint(): {"reason": "pinned"}}}))
    (pkg / "mod.py").write_text(
        src.replace(
            "        if self._latest is not None:\n",
            "        if self._latest is not None:  # graftlint: disable=THR001(test: known-benign)\n",
        )
    )
    after = lint_repo(str(corpus), paths=[str(pkg)], baseline_path=str(fake))
    assert after.stale_baseline == [], after.stale_baseline
    assert any(f.fingerprint() == pinned.fingerprint() for f in after.suppressed)
    assert not any(f.fingerprint() == pinned.fingerprint() for f in after.findings)


# ------------------------------------------------------- atomic-read nuance


def _lint_source(tmp_path, source: str):
    pkg = tmp_path / PKG
    pkg.mkdir(exist_ok=True)
    (pkg / "mod.py").write_text(textwrap.dedent(source))
    return lint_repo(str(tmp_path), paths=[str(pkg)])


def test_atomic_tuple_single_read_is_clean(tmp_path):
    report = _lint_source(
        tmp_path,
        """
        import threading

        class L:
            def __init__(self):
                self._latest = (-1, {})
                self._t = None
            def start(self):
                self._t = threading.Thread(target=self._run)
            def _run(self):
                self._latest = (0, {"a": 1.0})
            def latest(self):
                return dict(self._latest[1])
        """,
    )
    assert [f.render() for f in report.findings] == []


def test_double_read_of_rebound_attr_is_flagged(tmp_path):
    report = _lint_source(
        tmp_path,
        """
        import threading

        class L:
            def __init__(self):
                self._latest = None
                self._t = None
            def start(self):
                self._t = threading.Thread(target=self._run)
            def _run(self):
                self._latest = (0, {})
            def latest(self):
                if self._latest is not None:
                    return self._latest[1]
                return {}
        """,
    )
    assert any(f.rule == "THR001" for f in report.findings)


def test_multi_item_with_counts_as_nested_acquisition(tmp_path):
    report = _lint_source(
        tmp_path,
        """
        import threading

        class C:
            def __init__(self):
                self.a = threading.Lock()
                self.b = threading.Lock()
            def one(self):
                with self.a, self.b:
                    pass
            def two(self):
                with self.b:
                    with self.a:
                        pass
        """,
    )
    assert any(f.rule == "THR002" for f in report.findings)
    clean = _lint_source(
        tmp_path,
        """
        import threading

        class C:
            def __init__(self):
                self.a = threading.Lock()
                self.b = threading.Lock()
            def one(self):
                with self.a, self.b:
                    pass
            def two(self):
                with self.a:
                    with self.b:
                        pass
        """,
    )
    assert not any(f.rule == "THR002" for f in clean.findings)


def test_suppression_reason_may_contain_parens():
    from dotaclient_tpu_torch.analysis.core import Suppressions

    src = "x = 1  # graftlint: disable=THR001(len() is one GIL-atomic read), OBS001(see the (name) contract)\n"
    sup = Suppressions(src)
    assert sup.missing_reason == []
    assert sup.covers("THR001", 1)
    assert sup.covers("OBS001", 1)
    assert sup._by_line[1]["THR001"] == "len() is one GIL-atomic read"
    assert sup._by_line[1]["OBS001"] == "see the (name) contract"


def test_suppression_spaced_equals_is_parsed():
    from dotaclient_tpu_torch.analysis.core import Suppressions

    sup = Suppressions("x = 1  # graftlint: disable = THR001(spaced form)\n")
    assert sup.covers("THR001", 1)
    bare = Suppressions("x = 1  # graftlint: disable = THR001\n")
    assert not bare.covers("THR001", 1)
    assert bare.missing_reason == [(1, "THR001")]


def test_inline_suppression_with_reason_suppresses(tmp_path):
    report = _lint_source(
        tmp_path,
        """
        import threading

        class L:
            def __init__(self):
                self._pending = []
                self._t = None
            def start(self):
                self._t = threading.Thread(target=self._run)
            def _run(self):
                self._pending.append(1)
            def depth(self):
                return len(self._pending)  # graftlint: disable=THR001(len is one atomic read)
        """,
    )
    assert report.findings == []
    assert len(report.suppressed) == 1


# ------------------------------------------------------- parity vs reference


def _port_path(ref_path: str) -> str:
    """The twin corpus's path of a reference corpus path."""
    if ref_path.startswith("scripts/"):
        return f"{PKG}/{ref_path}"
    if ref_path == "dotaclient_tpu/native/packer.cc":
        return f"{PKG}/csrc/packer.cc"
    if ref_path.startswith("dotaclient_tpu/"):
        return PKG + ref_path[len("dotaclient_tpu"):]
    return ref_path


@pytest.mark.parametrize("family", ["THR", "OBS", "SVC"])
def test_same_rules_fire_at_the_same_lines_as_the_reference(family):
    """The reference's lint on its corpus and the port's on the twin
    corpus: each family's (rule, file, line) findings are equal, path for
    path, and so are the reason-less suppressions."""
    ref = ref_lint_repo(REF_FIXTURES)
    port = _fixture_report()
    key = lambda f: (f.rule, f.path, f.line)  # noqa: E731
    want = sorted((f.rule, _port_path(f.path), f.line) for f in ref.findings if f.rule.startswith(family))
    got = sorted(key(f) for f in port.findings if f.rule.startswith(family))
    assert want, f"the reference corpus fires no {family} rule"
    assert got == want
    assert sorted((_port_path(f.path), f.line) for f in ref.invalid) == sorted((f.path, f.line) for f in port.invalid)


# ---------------------------------------------- lifecycle/wire on a real tree


def _package_copy(tmp_path):
    """A linted-shape copy of the real tree: the package and k8s."""
    shutil.copytree(
        os.path.join(REPO_ROOT, PKG), tmp_path / PKG, ignore=shutil.ignore_patterns("__pycache__")
    )
    shutil.copytree(os.path.join(REPO_ROOT, "k8s"), tmp_path / "k8s")
    return tmp_path


def _mutate(path, old: str, new: str) -> None:
    src = path.read_text()
    assert old in src, f"{path.name}: the mutant's pin moved — update it"
    path.write_text(src.replace(old, new))


def test_wire001_head_parity():
    """WIRE001 derives the SAME DTR layout from the port's serialize.py
    (ast) and its csrc/packer.cc (regex) on HEAD, and it is the
    reference's layout."""
    from dotaclient_tpu_torch.analysis.lif_rules import parse_packer_spec, parse_serialize_spec

    py, py_errs = parse_serialize_spec(os.path.join(REPO_ROOT, PKG, "transport", "serialize.py"))
    cc, cc_errs = parse_packer_spec(os.path.join(REPO_ROOT, PKG, "csrc", "packer.cc"))
    assert py_errs == [] and cc_errs == []
    assert py.diffs(cc) == []
    assert py.header_bytes == 21 and py.trace_ext_bytes == 16
    assert py.codes == {"f32": 0, "i32": 1, "u8": 2, "bf16": 3}
    assert len(py.maps[(False, False)]) == 16
    assert len(py.maps[(True, True)]) == 19
    ref, _ = parse_packer_spec(os.path.join(REPO_ROOT, "dotaclient_tpu", "native", "packer.cc"))
    assert cc.maps == ref.maps and cc.codes == ref.codes


LEASE_MUTANTS = {
    # the reaper releases whether or not the copy's event completed
    "reap_without_query": (
        "            if ready is None or ready.query():\n                lease.release()",
        "            if True:\n                lease.release()",
        "_LeaseReaper.reap",
    ),
    # teardown releases with no event of the copy synchronised
    "release_all_without_event": (
        "            if ready is not None:\n                ready.synchronize()\n            lease.release()",
        "            lease.release()",
        "_LeaseReaper.release_all",
    ),
    # the fetch hands the slot back at copy dispatch
    "release_at_dispatch": (
        "            self._leases.hold(lease, payload[1])",
        "            lease.release()",
        "Learner._fetch_next",
    ),
}


@pytest.mark.parametrize("mutant", sorted(LEASE_MUTANTS))
def test_early_lease_release_mutant_fails_lint(tmp_path, mutant):
    """Re-introduce a release with no event of the lease's copy fenced
    into the REAL learner: LIF001 catches each shape. (The dynamic half
    is schedcheck's ring model, tests/test_torch_schedcheck.py.)"""
    old, new, where = LEASE_MUTANTS[mutant]
    root = _package_copy(tmp_path)
    _mutate(root / PKG / "runtime" / "learner.py", old, new)
    report = lint_repo(str(root), rules=["LIF001"])
    lif = [f for f in report.findings if f.rule == "LIF001"]
    assert lif, f"{mutant} not caught by LIF001"
    assert any(where in f.context for f in lif), [f.render() for f in lif]


def test_packer_layout_drift_mutant_fails_lint(tmp_path):
    """A dtype-map loop-boundary edit in the REAL csrc/packer.cc that
    serialize.py does not mirror fails WIRE001."""
    root = _package_copy(tmp_path)
    pp = root / PKG / "csrc" / "packer.cc"
    _mutate(pp, "for (int64_t i = 6; i < 10; ++i)", "for (int64_t i = 6; i < 9; ++i)")
    _mutate(pp, "for (int64_t i = 10; i < n_map; ++i)", "for (int64_t i = 9; i < n_map; ++i)")
    report = lint_repo(str(root), rules=["WIRE001"])
    wire = [f for f in report.findings if f.rule == "WIRE001"]
    assert wire and all("dtype-map" in f.message for f in wire)


def test_packer_wire_code_drift_mutant_fails_lint(tmp_path):
    """A wire-code renumbering in the REAL csrc/packer.cc alone fails
    WIRE001, naming the code."""
    root = _package_copy(tmp_path)
    _mutate(root / PKG / "csrc" / "packer.cc", "kWireU8 = 2, kWireBf16 = 3", "kWireU8 = 2, kWireBf16 = 5")
    report = lint_repo(str(root), rules=["WIRE001"])
    assert any("wire code bf16: 3 (py) vs 5 (cc)" in f.message for f in report.findings)


def test_packer_unparseable_layout_is_itself_a_finding(tmp_path):
    root = _package_copy(tmp_path)
    _mutate(root / PKG / "csrc" / "packer.cc", "constexpr int64_t kHeaderBytes", "static int64_t header_bytes")
    report = lint_repo(str(root), rules=["WIRE001"])
    wire = [f for f in report.findings if f.rule == "WIRE001"]
    assert wire and any("extraction failed" in f.message for f in wire)


def test_wire_pair_half_missing_is_loud(tmp_path):
    root = _package_copy(tmp_path)
    os.remove(root / PKG / "csrc" / "packer.cc")
    report = lint_repo(str(root), rules=["WIRE001"])
    wire = [f for f in report.findings if f.rule == "WIRE001"]
    assert wire and any("lost half its pair" in f.message for f in wire)


def test_serialize_alias_refactor_is_loud_not_dead(tmp_path):
    root = _package_copy(tmp_path)
    _mutate(
        root / PKG / "transport" / "serialize.py",
        "codes = [obs_code] * 3 + [_WIRE_U8] * 3 + [_WIRE_I32] * 4 + [_WIRE_F32] * 6",
        "f = _WIRE_F32\n    codes = [obs_code] * 3 + [_WIRE_U8] * 3 + [_WIRE_I32] * 4 + [f] * 6",
    )
    report = lint_repo(str(root), rules=["WIRE001"])  # must not raise
    wire = [f for f in report.findings if f.rule == "WIRE001"]
    assert wire and any("extraction failed" in f.message for f in wire)


def test_scripts_flag_drift_mutant_fails_lint(tmp_path):
    """The OBS002 scripts pass on a REAL-shaped tree: a driver of the
    port spawning a known binary with an unknown flag fails the lint."""
    root = _package_copy(tmp_path)
    (root / PKG / "scripts" / "bad_driver.py").write_text(
        "import subprocess, sys\n"
        "def spawn():\n"
        "    subprocess.Popen([sys.executable, '-m',\n"
        "                      'dotaclient_tpu_torch.serve.server',\n"
        "                      '--serve.port', '0',\n"
        "                      '--serve.bogus_knob', '1'])\n"
    )
    report = lint_repo(str(root), rules=["OBS002"])
    obs = [f for f in report.findings if f.rule == "OBS002"]
    assert any("--serve.bogus_knob" in f.message for f in obs)


def test_manifest_flag_drift_mutant_fails_lint(tmp_path):
    """A manifest names the reference's binary; the port checks its flags
    against the twin's namespace, so an unknown flag there fails."""
    root = _package_copy(tmp_path)
    _mutate(root / "k8s" / "learner.yaml", '- "--batch_size"', '- "--batch_sizee"')
    report = lint_repo(str(root), rules=["OBS002"])
    assert any("--batch_sizee" in f.message and "learner.yaml" in f.path for f in report.findings)


# ------------------------------------------------------------- nightly lane


@pytest.mark.nightly
@pytest.mark.slow
def test_lint_strict_nightly():
    """The --strict entry point passes on the checked-in tree, run as a
    module the way the GPU smoke runs it."""
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.scripts.lint_graft", "--strict", "--json"],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=REPO_ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout.strip().splitlines()[-1])
    assert payload["ok"] and payload["files_scanned"] > 50
