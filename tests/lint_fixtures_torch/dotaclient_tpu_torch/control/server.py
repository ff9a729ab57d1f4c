"""Fixture control binary for the SVC rules: serves /topology on its
MetricsHTTPServer surface and consumes the ControlMini fields. The
fleetd fixture dials this binary's routes (one good, one drifted).
Never imported — AST only."""

from dotaclient_tpu_torch.obs.http import MetricsHTTPServer  # fixture-only


def run(cfg):
    topology = {"tiers": {}}
    srv = MetricsHTTPServer(
        cfg.control.port,
        json_routes={"/topology": lambda: topology},
    )
    # consumes --control.policy (OBS003 good side)
    topology["policy"] = cfg.control.policy
    return srv
