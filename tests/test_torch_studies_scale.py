"""The float32 runs of the ``train_at_scale`` study and of the JAX
package's script (its main up to the counts it prints, then stopped),
compared on their integer counts only (the float64 trajectories are held
in tests/test_torch_studies_train.py).
"""
import re

import pytest

import jax

from depth_correction_tpu_torch.studies import train_at_scale as tas
from torch_studies_common import small_chunks  # noqa: F401


class _Counted(Exception):
    """Stops the JAX script once it has printed its counts."""


def test_train_at_scale_float32_counts_match_jax(capsys, monkeypatch, tmp_path, small_chunks):
    """Both scripts' main in float32 on the gather engine: the same global
    points, query rows and K on their first [scale] line (the rows in the
    loss are not compared: in float32 the planar masks of exact planes
    follow rounding, ROADMAP). The JAX script stops when it builds its loss,
    after that line; the port's step lines follow."""
    import train_at_scale as jtas

    import depth_correction_tpu.train as jtrain

    def stop(cfg):
        raise _Counted

    monkeypatch.setattr(jtrain, "make_loss_fn", stop)
    monkeypatch.delenv("DC_MOMENTS_BACKEND", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))  # the JAX script's compilation cache
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    argv = ["--density", "10", "--size", "6_6_3", "--steps", "1"]
    try:
        with pytest.raises(_Counted):
            jtas.main(argv)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    jout = capsys.readouterr().out
    res = tas.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    pat = r"\[scale\] (\d+) global points, (\d+) query rows \((\d+) in loss\), K=(\d+)"
    want = [int(v) for i, v in enumerate(re.search(pat, jout).groups()) if i != 2]
    assert [int(v) for i, v in enumerate(re.search(pat, tout).groups()) if i != 2] == want
    assert [res[k] for k in ("global", "query", "k")] == want
    assert res["engine"] == "gather" and len(res["step_ms"]) == 1
    assert "ms/step" in tout and "step median" in tout
