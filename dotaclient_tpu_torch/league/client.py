"""Stdlib HTTP client of the league service (own copy of
dotaclient_tpu/league/client.py): plain urllib, no dependency on the
service's code beyond the param-tree wire form.

Param trees cross as base64 JSON (league/server.py `_encode_named`);
everything else is plain JSON.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote
from urllib.request import Request, urlopen


class LeagueClient:
    def __init__(self, endpoint: str, timeout_s: float = 5.0):
        self.endpoint = str(endpoint)
        self.timeout_s = float(timeout_s)

    # ------------------------------------------------------------- plumbing

    def _get(self, path: str) -> dict:
        with urlopen(f"http://{self.endpoint}{path}", timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8", "replace"))

    def _post(self, path: str, body: dict) -> dict:
        req = Request(
            f"http://{self.endpoint}{path}",
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8", "replace"))

    # -------------------------------------------------------------- surface

    def match(self) -> dict:
        return self._get("/match")

    def result(self, winner: str, loser: str, draw: bool = False) -> dict:
        return self._post("/result", {"winner": winner, "loser": loser, "draw": draw})

    def leaderboard(self) -> List[dict]:
        return self._get("/leaderboard")["leaderboard"]

    def lineage(self) -> Dict[str, dict]:
        return self._get("/lineage")["lineage"]

    def assignments(self) -> Dict[str, dict]:
        return self._get("/assignments")["assignments"]

    def snapshot(self, name: str) -> dict:
        return self._get(f"/snapshot?name={quote(name)}")

    def register(
        self,
        name: str,
        version: int,
        named_params: List[Tuple[str, "object"]],
        kind: str = "snapshot",
        parent: Optional[str] = None,
    ) -> dict:
        from dotaclient_tpu_torch.league.server import _encode_named

        return self._post(
            "/snapshot",
            {
                "name": name,
                "version": int(version),
                "kind": kind,
                "parent": parent,
                "params": _encode_named(named_params),
            },
        )
