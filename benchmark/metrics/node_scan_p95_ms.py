"""The 95th percentile of the window's per-scan wall times (every scan of
the window, host clock; each ends in the copy back to numpy)."""
import statistics


def read(ctx):
    times = (ctx.get("window") or {}).get("item_s")
    if not times or len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[-1] * 1e3
