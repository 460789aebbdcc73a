"""Write dynamic-object-filtered KITTI-360 scans to the data_3d_filtered
layout (reference: scripts/generate_scans_wo_dynamic_objects_kitti360).

Port of the JAX package's script of that name: the command-line wrapper
over ``datasets.kitti360.remove_dynamic_objects`` (scipy's cKDTree on the
host; ``--device`` is checked as every study checks it).

Usage:
    python -m depth_correction_tpu_torch.studies.generate_scans_wo_dynamic_objects_kitti360 \\
        <dataset name, e.g. kitti360/00_start_100_end_150_step_1> \\
        [--out-dir DIR] [--dist-th 0.2] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys

from . import add_device_arg, torch_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("name", help="kitti360/<slice> dataset name")
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--dist-th", type=float, default=0.2,
                        help="drop points within this distance [m] of a dynamic semantic point")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..datasets.kitti360 import Dataset, remove_dynamic_objects

    torch_device(args.device)
    ds = Dataset(args.name.split("/", 1)[-1])
    out = remove_dynamic_objects(ds, out_dir=args.out_dir, dist_th=args.dist_th)
    print("Filtered scans written to %s" % out)
    print("Load them with Dataset(..., filtered_scans=True).")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
