"""The system under test: ``repro_torch``'s compressor, and nothing else of it.

The only module of the benchmark that imports the program. The benchmark
hands the compressor fields on the device and takes back container bytes
(compress) and fields on the device (decompress); it reads the program's
plan-cache counters and the verify record of its last compress, and
records nothing else of it. The program's kernels build into the
benchmark's own fixed cache inside the checkout, set before the program
is imported.
"""
from __future__ import annotations

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
KERNEL_CACHE = pathlib.Path(__file__).resolve().parent / ".cache" / "kernels"


def import_program():
    """Import ``repro_torch`` from the checkout, its kernel cache set to the
    benchmark's directory."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(KERNEL_CACHE)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.core.compressor as compressor
    import repro_torch.core.plancache as plancache

    return compressor, plancache


class Program:
    """One ``Compressor`` of a configuration's spec, with its plan cache
    where the traffic asks for one."""

    def __init__(self, spec: dict, device, plan_cache: bool):
        compressor, plancache = import_program()
        if device.type == "cuda":
            from repro_torch.kernels import build

            build.build()  # every kernel from the cache; the first run of a checkout compiles
        self.cache = plancache.PlanCache() if plan_cache else None
        self.comp = compressor.Compressor(compressor.CompressorSpec(**spec), device=device, plan_cache=self.cache)

    def compress(self, x):
        return self.comp.compress(x)

    def decompress(self, buf):
        return self.comp.decompress(buf, out="device")

    def counters(self) -> dict:
        if self.cache is None:
            return {}
        return {"plan_cache_hits": self.cache.hits, "plan_cache_misses": self.cache.misses}

    def last_repairs(self) -> int:
        """Re-encodes of the last compress (each adds a compress and a full
        decode of work)."""
        return int(((self.comp.last_telemetry or {}).get("verify") or {}).get("repairs", 0))
