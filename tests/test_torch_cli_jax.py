"""One path-tracing run of the port's CLI against the JAX package's CLI on
the same statefile library (scene/library.py:write_library at
16x16, spp 2), held through the checkpoints' fb_sum.

Tolerance: the image rule of tests/test_torch_pt.py, >= 99% of pixels of
the mean within 1e-3 of the JAX package's. The JAX CLI points JAX's
persistent compilation cache at a fixed absolute path (hydracore_tpu/app/
cli.py); the test drops those two jax.config updates, so this run writes no
compilation cache and leaves JAX's settings as they were.
"""
import jax
import numpy as np
import pytest
import torch

from hydracore_tpu.app import cli as jcli
from hydracore_tpu_torch.app import cli as pcli
from hydracore_tpu_torch.scene.library import write_library
from hydracore_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def no_jax_cache(monkeypatch):
    """jax.config.update with the CLI's compilation-cache settings dropped;
    yields the keys that were dropped."""
    update, dropped = jax.config.update, []

    def kept_update(key, value):
        if key in _CACHE_KEYS:
            dropped.append(key)
        else:
            update(key, value)

    monkeypatch.setattr(jax.config, "update", kept_update)
    yield dropped


def test_port_cli_matches_jax_cli(tmp_path, capsys, no_jax_cache):
    cache_dir = jax.config.jax_compilation_cache_dir
    write_library(tmp_path, size=16)
    lib = str(tmp_path)
    common = ["-inputlib", lib, "-spp", "2"]
    assert jcli.main(common + ["-out", str(tmp_path / "j.png"), "-checkpoint",
                               str(tmp_path / "j.npz")]) == 0
    jax_out = capsys.readouterr().out
    assert sorted(no_jax_cache) == sorted(_CACHE_KEYS)
    assert jax.config.jax_compilation_cache_dir == cache_dir
    assert pcli.main(common + ["-out", str(tmp_path / "p.png"), "-checkpoint",
                               str(tmp_path / "p.npz")], device="cpu") == 0
    port_out = capsys.readouterr().out
    fj, spp_j, seed_j = load_checkpoint(str(tmp_path / "j.npz"))
    fp, spp_p, seed_p = load_checkpoint(str(tmp_path / "p.npz"))
    assert (spp_p, seed_p) == (spp_j, seed_j) == (2, 5)
    close = float((np.abs(fp / 2 - fj / 2).max(-1) <= 1e-3).mean())
    assert close >= 0.99, close
    assert fp.sum() > 0.0
    # the same printed lines, timings aside
    for out in (jax_out, port_out):
        assert out.startswith("[scene] 40 tris, 5 materials, 2 lights, 16x16 (")
        assert "[pass] spp = 2/2, speed = " in out and "[done] saved " in out
