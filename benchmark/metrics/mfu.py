"""mfu.<cell kind>: an item's (a training step's, a corrected scan's, a
registration's) share of the card's peaks: the least time of its needed
work at published peaks (the driver's ``item_work``, from
benchmark/roofline.py and the reference's counts) over the window's mean
item on the host clock."""
from benchmark import roofline


def read(ctx):
    work = (ctx.get("verdict") or {}).get("item_work")
    win = ctx.get("window") or {}
    if work is None or not win.get("items"):
        return None
    return roofline.share(work, win["window_s"] / win["items"])
