"""Known-bad/known-good OBS001 emitters + flag consumption for OBS003.
Never imported — AST only."""

from dotaclient_tpu_torch.runtime.metrics import MetricsLogger  # fixture-only


def good_window(metrics, cfg, step):
    # consumes batch_size/seq_len/enabled/metrics_port (OBS003 good side)
    scalars = {"good_scalar": float(cfg.batch_size * cfg.seq_len)}
    scalars["fam_le_5"] = 1.0 if cfg.obs.enabled else 0.0
    scalars["loss"] = float(cfg.obs.metrics_port)
    metrics.log(step, scalars)


def bad_window(step):
    metrics = MetricsLogger("")
    # OBS001: dict-literal key not in the registry
    metrics.log(step, {"good_scalar": 1.0, "rogue_scalar": 2.0})


def bad_subscript_window(metrics, step):
    scalars = {}
    scalars["fam_le_10"] = 1.0
    # OBS001: subscript store of an unregistered name on the logged dict
    scalars["another_rogue"] = 2.0
    metrics.log(step, scalars)


def bad_literal_initializer_window(metrics, step):
    # OBS001: rogue name in the dict-LITERAL INITIALIZER of the logged
    # var (not a subscript store)
    scalars = {"good_scalar": 1.0, "rogue_in_initializer": 2.0}
    metrics.log(step, scalars)


def good_fstring_window(metrics, step):
    scalars = {"loss": 0.0}
    # dynamically-composed key whose constant head sits inside the
    # registered fam_ family — clean
    scalars[f"fam_le_{step}"] = 1.0
    metrics.log(step, scalars)


def bad_fstring_window(metrics, step):
    scalars = {"loss": 0.0}
    # OBS001: dynamically-composed head no PREFIXES family can contain
    scalars[f"rogue_fam_{step}"] = 2.0
    metrics.log(step, scalars)
