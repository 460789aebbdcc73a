"""L-BFGS and Adam as the JAX package trains with them (counterpart of
``depth_correction_tpu/train.py:891-912``, which chains optax 0.2.6's
transforms).

:class:`Adam` is optax's ``adam`` with the two options ``torch.optim.Adam``
lacks: ``eps_root`` (under the square root of the second moment) and
``nesterov`` (optax's Nesterov form; ``torch.optim.NAdam`` decays its
momentum on a schedule of its own and is another algorithm).

:class:`LBFGS` carries its own copy of optax's algorithm:

- ``scale_by_lbfgs`` (optax ``_src/transform.py``): the two-loop recursion
  over the last ``memory_size`` differences of parameters and gradients,
  the identity scaled by ``<dw, du> / <du, du>`` of the newest pair and, at
  the first step, by ``min(1, 1 / |g|)``;
- then either ``scale(-1)`` and ``scale_by_zoom_linesearch`` (optax
  ``_src/linesearch.py``: the strong-Wolfe zoom of Nocedal and Wright,
  algorithms 3.5 and 3.6, with Hager and Zhang's approximate decrease
  test, at optax's defaults and ``initial_guess_strategy='keep'``, so each
  step's first trial is the previous step's stepsize), or, without the line
  search, ``scale(-lr)``.

``torch.optim.LBFGS`` is another algorithm (its first step is scaled by
``1 / |g|_1``, each ``step()`` runs ``max_iter`` inner iterations, its
cubic interpolation and tolerances differ) and cannot follow the JAX
package's trajectory.

The parameters are a flat list of tensors, updated in place. A step takes
the loss and the gradients (``p.grad``) at the current parameters and,
with the line search, a closure that evaluates the loss and its gradients
at the parameters as they stand (the line search sets them to each trial
point first). The line search's scalar logic runs on the host in float64.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["Adam", "LBFGS"]


def _vdot(xs, ys) -> torch.Tensor:
    """<x, y> summed over the leaves, a 0-d tensor."""
    return sum((x * y).sum() for x, y in zip(xs, ys))


def _params_of(params) -> list:
    """A flat list of tensors from tensors or parameter groups."""
    out = []
    for p in params:
        out.extend(p["params"] if isinstance(p, dict) else [p])
    return out


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax ``_cubicmin``); NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax ``_quadmin``)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


class _ZoomLinesearch:
    """optax 0.2.6's ``zoom_linesearch`` at its defaults (``tol`` 0,
    ``increase_factor`` 2, ``slope_rtol`` 1e-4, ``curv_rtol`` 0.9,
    ``approx_dec_rtol`` 1e-6, ``interval_threshold`` 1e-5, no largest
    stepsize), one trial point a loop, its state on the host in float64."""

    def __init__(self, max_linesearch_steps: int):
        self.max_steps = int(max_linesearch_steps)
        self.tol = 0.0
        self.increase_factor = 2.0
        self.slope_rtol = 1e-4
        self.curv_rtol = 0.9
        self.approx_dec_rtol = 1e-6
        self.interval_threshold = 1e-5

    def _decrease_error(self, stepsize, value_step, slope_step, value_init, slope_init):
        err = value_step - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope_step - (2 * self.slope_rtol - 1.0) * slope_init
        delta_values = value_step - value_init - self.approx_dec_rtol * np.abs(value_init)
        approx = np.maximum(approx, delta_values)
        err = np.maximum(np.minimum(approx, err), 0.0)
        return np.float64(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope_step, slope_init):
        err = np.maximum(np.abs(slope_step) - self.curv_rtol * np.abs(slope_init), 0.0)
        return np.float64(np.inf) if np.isnan(err) else err

    def search(self, evaluate, updates, value, grad, stepsize_guess):
        """The stepsize along ``updates``.

        :param evaluate: ``evaluate(stepsize) -> (value, grads)`` at the
            parameters plus ``stepsize * updates``.
        """
        f64 = np.float64
        slope = f64(_vdot(updates, grad).item())
        value = f64(value)
        s = {"count": 0, "stepsize": f64(0.0), "value": value, "slope": slope,
             "decrease_error": f64(np.inf), "curvature_error": f64(np.inf),
             "interval_found": False, "done": False, "failed": False,
             "low": f64(0.0), "value_low": value, "slope_low": slope,
             "high": f64(0.0), "value_high": value, "slope_high": slope,
             "cubic_ref": f64(0.0), "value_cubic_ref": value,
             "safe_stepsize": f64(0.0), "safe_value": value}
        value_init, slope_init = value, slope

        def on_line(stepsize):
            v, g = evaluate(stepsize)
            return f64(v), f64(_vdot(g, updates).item())

        while not (s["done"] or s["failed"]):
            it = s["count"]
            if not s["interval_found"]:
                prev_stepsize, prev_value, prev_slope = s["stepsize"], s["value"], s["slope"]
                new = f64(stepsize_guess) if it == 0 else self.increase_factor * prev_stepsize
                v, sl = on_line(new)
                dec = self._decrease_error(new, v, sl, value_init, slope_init)
                curv = self._curvature_error(sl, slope_init)
                err = np.maximum(dec, curv)
                if dec <= self.tol:
                    s["safe_stepsize"], s["safe_value"] = new, v
                set_high = bool((dec > 0.0) or ((v >= prev_value) and it > 0))
                set_low = bool((sl >= 0.0) and not set_high)
                if set_low:
                    lo, hi = (new, v, sl), (prev_stepsize, prev_value, prev_slope)
                else:
                    lo, hi = (prev_stepsize, prev_value, prev_slope), (new, v, sl)
                interval_found = set_high or set_low or bool(err <= self.tol)
                done = bool(err <= self.tol)
                s.update(count=it + 1, stepsize=new, value=v, slope=sl,
                         decrease_error=dec, curvature_error=curv,
                         interval_found=interval_found, done=done,
                         failed=bool(it + 1 >= self.max_steps and not done),
                         low=lo[0], value_low=lo[1], slope_low=lo[2],
                         high=hi[0], value_high=hi[1], slope_high=hi[2],
                         cubic_ref=lo[0], value_cubic_ref=lo[1])
            else:
                low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
                high, value_high, slope_high = s["high"], s["value_high"], s["slope_high"]
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
                too_small = bool(delta <= self.interval_threshold)
                with np.errstate(all="ignore"):
                    mid_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                          s["cubic_ref"], s["value_cubic_ref"])
                    mid_quad = _quadmin(low, value_low, slope_low, high, value_high)
                use_cubic = bool((mid_cubic > left + cubic_chk) and (mid_cubic < right - cubic_chk))
                use_quad = (not use_cubic) and bool((mid_quad > left + quad_chk)
                                                    and (mid_quad < right - quad_chk))
                if use_cubic:
                    middle = mid_cubic
                elif use_quad:
                    middle = mid_quad
                else:
                    middle = (low + high) / 2.0
                v, sl = on_line(middle)
                dec = self._decrease_error(middle, v, sl, value_init, slope_init)
                curv = self._curvature_error(sl, slope_init)
                err = np.maximum(dec, curv)
                if dec <= self.tol and v < s["safe_value"]:
                    s["safe_stepsize"], s["safe_value"] = middle, v
                done = bool(err <= self.tol)
                set_high_mid = bool((dec > 0.0) or (v >= value_low))
                set_high_low = bool((sl * (high - low) >= 0.0) and not set_high_mid)
                new_high = (middle, v, sl) if set_high_mid else (high, value_high, slope_high)
                if set_high_low:
                    new_high = (low, value_low, slope_low)
                new_low = (middle, v, sl) if not set_high_mid else (low, value_low, slope_low)
                if set_high_mid or set_high_low:
                    cubic = (high, value_high)
                else:
                    cubic = (low, value_low)
                failed = (bool(it + 1 >= self.max_steps)
                          or (too_small and s["safe_stepsize"] > 0.0)) and not done
                s.update(count=it + 1, stepsize=middle, value=v, slope=sl,
                         decrease_error=dec, curvature_error=curv, done=done, failed=failed,
                         low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                         high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
                         cubic_ref=cubic[0], value_cubic_ref=cubic[1])
            if s["failed"]:
                # optax's _try_safe_step: the best point with sufficient
                # decrease, if any, or where the search stopped.
                if s["safe_stepsize"] > 0.0 or np.isinf(s["decrease_error"]):
                    s["stepsize"], s["value"] = s["safe_stepsize"], s["safe_value"]
        return s["stepsize"]


class Adam(torch.optim.Optimizer):
    """optax 0.2.6's ``adam(lr, b1, b2, eps, eps_root, nesterov=...)``
    (``scale_by_adam`` then ``scale_by_learning_rate``), as a torch
    optimizer over parameter groups. At step t, with g the gradient::

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        mu_hat = mu / (1 - b1^t), or with nesterov
                 b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)
        p -= lr * mu_hat / (sqrt(nu / (1 - b2^t) + eps_root) + eps)

    A parameter without a gradient is skipped, as ``torch.optim.Adam``
    skips it.
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 eps_root: float = 0.0, nesterov: bool = False):
        super().__init__(params, {"lr": float(lr), "betas": tuple(float(b) for b in betas),
                                  "eps": float(eps), "eps_root": float(eps_root),
                                  "nesterov": bool(nesterov)})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["mu"] = (1.0 - b1) * g + b1 * st["mu"]
                st["nu"] = (1.0 - b2) * (g * g) + b2 * st["nu"]
                t = st["count"] = st["count"] + 1
                if group["nesterov"]:
                    mu_hat = (b1 * (st["mu"] / (1.0 - b1 ** (t + 1)))
                              + (1.0 - b1) * (g / (1.0 - b1 ** t)))
                else:
                    mu_hat = st["mu"] / (1.0 - b1 ** t)
                nu_hat = st["nu"] / (1.0 - b2 ** t)
                update = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])
                p.add_((-group["lr"]) * update)


class LBFGS:
    """optax 0.2.6's L-BFGS on a list of tensors, updated in place: with
    ``line_search`` the transforms of ``optax.lbfgs(learning_rate=None,
    memory_size, linesearch=scale_by_zoom_linesearch(max_linesearch_steps))``,
    without it ``chain(scale_by_lbfgs(memory_size), scale_by_learning_rate(lr))``
    (JAX package, train.py:896-912).

    ``step(value, closure)`` reads each parameter's ``.grad`` (frozen
    coordinates carry a zero gradient and stay put); ``closure()`` returns
    (loss, gradients) at the parameters as they stand and is called once
    for each trial point of the line search.
    """

    def __init__(self, params, lr: float = 1.0, memory_size: int = 10,
                 line_search: bool = True, max_linesearch_steps: int = 20):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.params = _params_of(params)
        self.lr = float(lr)
        self.memory_size = int(memory_size)
        self.line_search = _ZoomLinesearch(max_linesearch_steps) if line_search else None
        ps = self.params
        dtype = ps[0].dtype if ps else torch.float64
        device = ps[0].device if ps else None
        self.state = {
            "count": 0,
            "params": [torch.zeros_like(p) for p in ps],
            "updates": [torch.zeros_like(p) for p in ps],
            "diff_params": [torch.zeros((self.memory_size,) + p.shape, dtype=p.dtype,
                                        device=p.device) for p in ps],
            "diff_updates": [torch.zeros((self.memory_size,) + p.shape, dtype=p.dtype,
                                         device=p.device) for p in ps],
            "weights": torch.zeros(self.memory_size, dtype=dtype, device=device),
            "learning_rate": 1.0,
        }

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {k: (list(v) if isinstance(v, list) else v) for k, v in self.state.items()}

    def load_state_dict(self, state: dict) -> None:
        self.state = {k: (list(v) if isinstance(v, (list, tuple)) else v)
                      for k, v in state.items()}

    def _direction(self, grads) -> list:
        """scale_by_lbfgs: update the memory with the newest differences,
        then the two-loop product of the inverse-Hessian model with
        ``grads``."""
        st, m = self.state, self.memory_size
        count = st["count"]
        memory_idx, prev_idx = count % m, (count - 1) % m
        with torch.no_grad():
            params = [p.detach() for p in self.params]
            first = count == 0
            dps = [torch.zeros_like(p) if first else p - q for p, q in zip(params, st["params"])]
            dus = [torch.zeros_like(g) if first else g - u for g, u in zip(grads, st["updates"])]
            vdot = _vdot(dus, dps)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
            if first:
                weight = torch.zeros_like(weight)
            for mem, d in zip(st["diff_params"], dps):
                mem[prev_idx] = d
            for mem, d in zip(st["diff_updates"], dus):
                mem[prev_idx] = d
            st["weights"][prev_idx] = weight
            # optax's scale_init_precond=True: the first step is capped by
            # min(1, 1/|g|), later ones scaled by s.y / y.y.
            if first:
                norm = torch.sqrt(_vdot(grads, grads))
                identity_scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
            else:
                num, den = vdot, _vdot(dus, dus)
                identity_scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
            rhos = st["weights"]
            order = [(memory_idx + j) % m for j in range(m)]
            vec = list(grads)
            alphas = {}
            for i in reversed(order):
                alpha = rhos[i] * _vdot([d[i] for d in st["diff_params"]], vec)
                vec = [v + (-alpha) * du[i] for v, du in zip(vec, st["diff_updates"])]
                alphas[i] = alpha
            vec = [identity_scale * v for v in vec]
            for i in order:
                beta = rhos[i] * _vdot([du[i] for du in st["diff_updates"]], vec)
                vec = [v + (alphas[i] - beta) * dw[i] for v, dw in zip(vec, st["diff_params"])]
            st["count"] = count + 1
            st["params"] = [p.clone() for p in params]
            st["updates"] = [g.clone() for g in grads]
        return vec

    def step(self, value=None, closure: Optional[Callable] = None):
        """One L-BFGS step from the current parameters.

        :param value: the loss at the current parameters (line search).
        :param closure: ``closure() -> (loss, grads)`` at the parameters as
            they stand (line search).
        :return: the stepsize taken.
        """
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.detach() for p in self.params]
        direction = self._direction(grads)
        with torch.no_grad():
            if self.line_search is None:
                stepsize = self.lr
                updates = [(-self.lr) * d for d in direction]
                for p, u in zip(self.params, updates):
                    p.add_(u)
                return stepsize
            updates = [-1.0 * d for d in direction]
            base = [p.detach().clone() for p in self.params]

        def evaluate(stepsize):
            with torch.no_grad():
                for p, b, u in zip(self.params, base, updates):
                    p.copy_(b + float(stepsize) * u)
            v, g = closure()
            return float(v), [gi.detach() for gi in g]

        stepsize = self.line_search.search(
            evaluate, updates, float(value), grads, self.state["learning_rate"])
        self.state["learning_rate"] = float(stepsize)
        with torch.no_grad():
            for p, b, u in zip(self.params, base, updates):
                p.copy_(b + float(stepsize) * u)
        return float(stepsize)
