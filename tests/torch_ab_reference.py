"""Helpers of the A/B twins' tests (tests/test_torch_ab_*.py): the
reference's scripts/ab_*.py loaded as modules, and the flags their mains
parse."""

import argparse
import importlib.util
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def load_reference(name: str):
    """scripts/<name>.py as a module (scripts/ on sys.path while it loads,
    for the imports between the scripts)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(str(REPO / "scripts"))


class Stop(Exception):
    pass


def reference_args(monkeypatch, ref, argv, stop_at: str) -> dict:
    """The reference main's parsed flags for `argv`: parse_args recorded,
    main stopped at `stop_at` (its first call after parsing). A main that
    takes no argv reads sys.argv, which is set to `argv` meanwhile."""
    box = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        box["args"] = parse(self, args, namespace)
        return box["args"]

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(sys, "argv", ["ref", *argv])
    monkeypatch.setattr(ref, stop_at, stop)
    with pytest.raises(Stop):
        ref.main(argv) if ref.main.__code__.co_argcount else ref.main()
    return vars(box["args"])
