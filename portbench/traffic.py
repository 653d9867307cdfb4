"""The one generator of the benchmark's traffic, read from a mix's data file.

Every mix is a closed loop of one client: it sends its next request only
after the last one has come back, and takes the cell's resident fields in
turn, again and again. A mix (``traffic/<mix>.json``) says:

- ``ops``: what each request does to its field, in order: ``compress``
  (device field to container bytes on the host) and ``decompress``
  (container bytes to a field on the device). A request that compresses
  decodes what its compress made; where the window only decompresses, the
  fields are compressed once in set-up and the window decodes those
  containers.
- ``plan_cache``: ``none``, or ``setup``: one plan cache serves every
  compress, filled in set-up by one compress of each resident field in
  index order.

Set-up ends in one request of the mix on field 0, so that every shape the
window uses has run once. The fields are the configuration's resident ones
(:mod:`portbench.fields`).
"""
from __future__ import annotations

KEYS = {"ops": None, "plan_cache": ("none", "setup")}
OPS = ("compress", "decompress")


class Mix:
    def __init__(self, params: dict):
        missing = sorted(set(KEYS) - set(params))
        unknown = sorted(set(params) - set(KEYS) - {"why"})
        if missing or unknown:
            raise ValueError(f"traffic mix: missing keys {missing}, unknown keys {unknown}")
        for key, allowed in KEYS.items():
            if allowed is not None and params[key] not in allowed:
                raise ValueError(f"traffic mix: {key} = {params[key]!r}, not one of {allowed}")
        self.ops = tuple(params["ops"])
        if not self.ops or any(op not in OPS for op in self.ops) or len(set(self.ops)) != len(self.ops):
            raise ValueError(f"traffic mix: ops {self.ops} must be a non-empty ordered subset of {OPS}")
        if self.ops[-1] != "decompress":
            raise ValueError("traffic mix: every request ends in a decompress, which the reference judges")
        self.from_setup = "compress" not in self.ops
        self.plan_cache = params["plan_cache"] == "setup"

    def setup(self, codec, fields) -> dict:
        """The set-up the traffic needs: the containers the window decodes
        (where it only decompresses), the plan cache's fill, then one warm-up
        request. Returns the set-up containers by field."""
        containers = {i: codec.compress(x) for i, x in enumerate(fields)} if self.from_setup else {}
        if self.plan_cache:
            for x in fields:
                codec.compress(x)
        buf = codec.compress(fields[0]) if "compress" in self.ops else containers[0]
        codec.decompress(buf)
        return containers
