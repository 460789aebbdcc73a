"""How often a short torch.profiler profile records no kernel, with CUPTI
torn down between profiles (the profiler's default, ``TEARDOWN_CUPTI=1``)
and kept attached (``TEARDOWN_CUPTI=0``), and
:func:`scripts.queued_ms` beside the profiler's kernel durations and CUDA
events.

Each setting runs in a process of its own, since the profiler's native side
reads the variable: a one-rank NCCL group stays alive (as after
chip_smoke.py's phase 18), CUDA work, a child process and an all-reduce
come between the profiles, and each profile holds 20 calls of
``index_add_`` at X5's capped-graph shape (8,289,711 rows of 3 into
390,144), as :func:`scripts.kernel_ms` takes them. The settings run in
turns (torn down, kept, torn down, kept)::

    python -m depth_correction_tpu_torch.scripts.exp_profile_teardown [--profiles 200]
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import torch

from . import device_ms, kernel_ms, queued_ms, require_card

SETTINGS = ("1", "0", "1", "0")
PAIRS, POINTS = 8289711, 390144


def child(profiles: int) -> None:
    """One setting's run: the empty profiles among ``profiles``, then the
    three timers on three functions."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = require_card()
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    dist.init_process_group("nccl", init_method="tcp://localhost:%d" % port, world_size=1,
                            rank=0, device_id=torch.device("cuda:0"))
    ones = torch.ones(1 << 20, device=device)
    dist.all_reduce(ones)
    gen = torch.Generator(device=device).manual_seed(0)
    mat = torch.randn(2048, 2048, device=device, generator=gen)
    idx = torch.randint(0, POINTS, (PAIRS,), device=device, generator=gen)
    val = torch.randn(PAIRS, 3, device=device, generator=gen)

    def library():
        return torch.zeros((POINTS, 3), device=device).index_add_(0, idx, val)

    empty = 0
    t0 = time.perf_counter()
    for i in range(profiles):
        for _ in range(1 + i % 7):
            mat = (mat @ mat).clamp_(-1, 1)
        if i % 25 == 0:
            subprocess.run([sys.executable, "-c", "pass"], check=True)
            dist.all_reduce(ones)
        time.sleep(0.001 * (i % 5))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                library()
            torch.cuda.synchronize()
            time.sleep(0.005)
        empty += not any(e.device_type == DeviceType.CUDA and e.count > 0
                         for e in prof.key_averages())
    print("TEARDOWN_CUPTI=%s: %d of %d profiles recorded no kernel, %.1f s"
          % (os.environ.get("TEARDOWN_CUPTI"), empty, profiles, time.perf_counter() - t0),
          flush=True)
    small = torch.randn(1 << 16, device=device)
    for name, fn in (("index_add_", library), ("matmul 2048", lambda: mat @ mat),
                     ("add 65536", lambda: small + 1)):
        print("  %s: profiler %.4f ms, queued %.4f ms, events %.4f ms"
              % (name, kernel_ms(fn, device, 20), queued_ms(fn, device, 20),
                 device_ms(fn, device, 20)), flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profiles", type=int, default=200)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.profiles)
        return 0
    require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    rc = 0
    for setting in SETTINGS:
        env = dict(os.environ, TEARDOWN_CUPTI=setting)
        rc |= subprocess.run([sys.executable, "-m", __spec__.name, "--child", "--profiles",
                              str(args.profiles)], env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
