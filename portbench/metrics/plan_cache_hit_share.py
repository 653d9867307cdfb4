"""Share of the window's plan-cache lookups that hit: PlanCache.hits / (hits + misses),
counted by the program's cache over the window."""
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "Planner (core/autotune.py, core/plancache.py)"
MOVES = "compress_GBps"


def read(run):
    hits, misses = run.counters.get("plan_cache_hits", 0), run.counters.get("plan_cache_misses", 0)
    if hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
