"""Plain reference of a training cell: the scans' local features, the
frozen global graph and its masks, the normalised min-eigenvalue loss of a
ScaledPolynomial depth correction, its gradient by autograd, and Adam, in
plain torch. Imports nothing of the program; takes the scans and the
configuration's settings, and works out everything that prep derives
again.

Follows the program's documented semantics (the reference repository's
``config.py``, ``preproc.py``, ``loss.py`` and ``train.py``): per scan, the
within-r neighbourhoods (each point's ``nn_max_neighbors`` nearest where
capped), their covariance's eigen-features, the incidence angles and the
eigenvalue-ratio mask; the global cloud at the model's starting weights,
its within-r graph (capped: each row's nearest, then the mutual pairs
only), its features and the mask of the rows that enter the loss
(the local mask, at least ``min_valid_neighbors`` neighbours, the ratio
bounds); at each step the corrected global cloud over the frozen graph,
the rows' smallest eigenvalue over the clamped eigenvalue sum, relu, and
their mean.
"""
from __future__ import annotations

import torch

from .common import dtype_of, eig_features, eigvalsh, moments, mutual, pad_size, radius_pairs, \
    ratio_mask, round_tf32

__all__ = ["prepare", "run"]


def _local(pts, s: dict, precision: str):
    """A scan's local features: (inc angles, ratio mask) of its points."""
    n = pts.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=pts.device)
    rows, cols = radius_pairs(pts, valid, float(s["nn_r"]), cap=s.get("nn_max_neighbors"))
    _, _, cov = moments(pts, rows, cols, n, precision)
    depth = pts.norm(dim=1)
    dirs = pts / depth.clamp(min=1e-20)[:, None]
    lam, _, inc = eig_features(cov, dirs)
    return dirs, depth, inc, ratio_mask(lam, s.get("eigenvalue_ratio_bounds"))


def _world(prep: dict, depth: torch.Tensor, precision: str) -> torch.Tensor:
    """The global cloud's points: R (depth * dirs) + t, the rotation's
    operands rounded as ``precision`` says."""
    R = round_tf32(prep["R"], precision).to(depth.dtype)
    d = round_tf32(prep["dirs"], precision).to(depth.dtype)
    rd = torch.einsum("pij,pj->pi", R[prep["scan"]], d)
    return prep["t"][prep["scan"]] + depth[:, None] * rd


def prepare(scans, s: dict, device, precision: str = "float64") -> dict:
    """Everything prep derives, worked out again from the ``(scan, pose)``
    pairs under the settings ``s`` (the configuration's ``settings``):
    the local fields in the global padded layout (scan * N + point), the
    frozen graph's pairs, and the loss rows."""
    dt = dtype_of(precision)
    n_pad = max(pad_size(len(a)) for a, _ in scans)
    total = n_pad * len(scans)
    dirs = torch.zeros(total, 3, dtype=dt, device=device)
    depth = torch.zeros(total, dtype=dt, device=device)
    inc = torch.zeros(total, dtype=dt, device=device)
    lmask = torch.zeros(total, dtype=torch.bool, device=device)
    valid = torch.zeros(total, dtype=torch.bool, device=device)
    scan = torch.arange(len(scans), device=device).repeat_interleave(n_pad)
    for i, (arr, _) in enumerate(scans):
        p = torch.stack([torch.as_tensor(arr[k], device=device) for k in "xyz"], 1).to(dt)
        d, dep, a, m = _local(p, s, precision)
        sl = slice(i * n_pad, i * n_pad + p.shape[0])
        dirs[sl], depth[sl], inc[sl], lmask[sl], valid[sl] = d, dep, a, m, True
    poses = torch.stack([torch.as_tensor(T, device=device) for _, T in scans]).to(dt)
    prep = {"dirs": dirs, "depth": depth, "inc": inc, "lmask": lmask, "valid": valid,
            "scan": scan, "R": poses[:, :3, :3], "t": poses[:, :3, 3], "n_pad": n_pad}
    # The graph is established on the uncorrected global cloud.
    world = _world(prep, depth, precision)
    cap = s.get("nn_max_neighbors")
    rows, cols = radius_pairs(world, valid, float(s["nn_r"]), cap=cap)
    if cap is not None and s.get("nn_symmetrize", True):
        rows, cols = mutual(rows, cols, total)
    cnt, _, cov = moments(world, rows, cols, total, precision)
    lam, _, _ = eig_features(cov)
    gmask = (lmask & valid & (cnt >= int(s.get("min_valid_neighbors") or 0))
             & ratio_mask(lam, s.get("eigenvalue_ratio_bounds")))
    prep.update(rows=rows, cols=cols, gmask=gmask)
    return prep


def _start_w(s: dict, dt, device) -> torch.Tensor:
    mk = s.get("model_kwargs") or {}
    return torch.as_tensor(mk.get("w", [0.0] * len(mk.get("exponent", [2.0, 4.0]))),
                           dtype=dt, device=device)


def _exponent(s: dict, dt, device) -> torch.Tensor:
    return torch.as_tensor((s.get("model_kwargs") or {}).get("exponent", [2.0, 4.0]),
                           dtype=dt, device=device)


def _corrected(prep: dict, w: torch.Tensor, s: dict) -> torch.Tensor:
    """ScaledPolynomial: depth * (1 - sum_e w_e gamma^e) on the local mask."""
    ex = _exponent(s, w.dtype, w.device)
    bias = torch.pow(prep["inc"][:, None], ex) @ w
    return torch.where(prep["lmask"], prep["depth"] * (1.0 - bias), prep["depth"])


def loss(prep: dict, w: torch.Tensor, s: dict, precision: str = "float64",
         rows_keep=None) -> torch.Tensor:
    """The loss at weights ``w`` over the loss rows (or those of them that
    ``rows_keep`` marks)."""
    gmask = prep["gmask"] if rows_keep is None else prep["gmask"] & rows_keep
    sel = gmask[prep["rows"]]
    rows, cols = prep["rows"][sel], prep["cols"][sel]
    world = _world(prep, _corrected(prep, w, s), precision)
    _, _, cov = moments(world, rows, cols, world.shape[0], precision)
    lam = eigvalsh(cov[gmask])
    point = torch.relu(lam[:, 0] / lam.sum(1).clamp(min=1e-6))
    return point.mean()


def run(prep: dict, s: dict, steps: int = 3, precision: str = "float64",
        half_rows: bool = False) -> dict:
    """``steps`` Adam steps from the starting weights (torch.optim.Adam's
    update, betas (0.9, 0.999), eps 1e-8, lr ``s["lr"]``): {"losses" (each
    step's, at the weights it starts from), "grad0" (the first gradient),
    "w" (the weights after each step, the start first)}. ``half_rows``
    plants a fault: every other loss row left out, the mean over the rest."""
    dt = prep["depth"].dtype
    device = prep["depth"].device
    w = _start_w(s, dt, device)
    keep = None
    if half_rows:
        keep = torch.zeros_like(prep["gmask"])
        keep[torch.nonzero(prep["gmask"]).reshape(-1)[::2]] = True
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, float(s["lr"])
    out = {"losses": [], "grad0": None, "w": [w.clone()]}
    for t in range(1, steps + 1):
        wt = w.clone().requires_grad_(True)
        value = loss(prep, wt, s, precision, keep)
        (g,) = torch.autograd.grad(value, wt)
        out["losses"].append(float(value.detach()))
        if out["grad0"] is None:
            out["grad0"] = g.detach().clone()
        with torch.no_grad():
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            denom = v.sqrt() / (1 - b2 ** t) ** 0.5 + eps
            w = w - lr / (1 - b1 ** t) * m / denom
        out["w"].append(w.clone())
    return out
