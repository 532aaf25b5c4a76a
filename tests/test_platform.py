"""What the program needs from the machine it runs on: the peak table, the
compile-cache rule, the device description, and chip_smoke.py's checks and
its refusal to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from kquant.utils import cache as cc  # noqa: E402
from kquant.utils.roofline import (PEAKS, peaks,  # noqa: E402
                                   prefill_roofline_report, roofline_report)

H100 = "NVIDIA H100 80GB HBM3"


# -- peak table --------------------------------------------------------------


def test_h100_peaks_are_the_data_sheet():
    assert peaks(H100) == (3350.0, 989.0)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA GeForce RTX 4090",
                                  "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        peaks(kind)


def test_reports_use_the_table():
    from kquant.models.fixtures import random_qparams, tiny_config

    cfg = tiny_config()
    params = random_qparams(cfg)
    dec = roofline_report(params, cfg, 10.0, device_kind=H100)
    pre = prefill_roofline_report(params, cfg, 10.0, T=64, device_kind=H100)
    bw, tf = PEAKS[H100]
    assert dec["roofline_tok_s"] == pytest.approx(
        bw * 1e9 / dec["bytes_per_step"])
    assert pre["roofline_tok_s"] <= tf * 1e12 / pre["flops_per_token"] + 1e-6
    assert dec["device_kind"] == H100
    with pytest.raises(ValueError):
        roofline_report(params, cfg, 10.0, device_kind="cpu")


# -- compile cache -----------------------------------------------------------


def test_compile_cache_env_is_left_alone(monkeypatch, tmp_path):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_the_repo(monkeypatch, tmp_path):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cc, "REPO_CACHE", tmp_path / "jax_cc")
    assert cc.enable_compile_cache() == str(tmp_path / "jax_cc")
    assert (tmp_path / "jax_cc").is_dir()
    assert calls == [("jax_compilation_cache_dir", str(tmp_path / "jax_cc"))]


def test_repo_cache_path_is_fixed():
    assert cc.REPO_CACHE == REPO / ".cache" / "jax_cc"


# -- device description --------------------------------------------------------


def test_describe_on_cpu():
    from kquant.utils.device import describe

    d = describe()
    assert d["platform"] == "cpu" and d["count"] >= 1
    assert isinstance(d["kind"], str) and isinstance(d["cards"], str)


def test_gpu_name_power_without_nvidia_smi(monkeypatch):
    from kquant.utils import device

    monkeypatch.setattr(device.shutil, "which", lambda _: None)
    assert device.gpu_name_power() == "not available"


# -- chip_smoke.py -------------------------------------------------------------


def test_rel_error_and_check():
    ref = np.array([1.0, -4.0, 2.0])
    err, rel = chip_smoke.rel_error(ref + [0.0, 0.02, 0.0], ref)
    assert err == pytest.approx(0.02) and rel == pytest.approx(0.005)
    assert chip_smoke.check("ok", ref + 0.01, ref, 1e-2) <= 1e-2
    with pytest.raises(AssertionError):
        chip_smoke.check("bad", ref + 0.1, ref, 1e-2)


def test_rel_error_rejects_nan_and_shape():
    with pytest.raises(ValueError, match="non-finite"):
        chip_smoke.rel_error(np.array([np.nan]), np.array([1.0]))
    with pytest.raises(ValueError, match="shape"):
        chip_smoke.rel_error(np.zeros(2), np.zeros(3))


def test_top2_margin():
    assert chip_smoke.top2_margin(np.array([0.1, 3.0, 2.5, -1.0])) == \
        pytest.approx(0.5)


class _FakeEngine:
    """prefill returns logits whose top-2 margin is ``margin``."""

    def __init__(self, margin):
        self.margin = margin
        self.seen = []

    def new_cache(self, _b):
        return None

    def prefill(self, rows, _cache):
        self.seen.append(rows[0])
        return np.array([[0.0, 1.0, 1.0 + self.margin]]), None, None


def test_agree_or_tie_equal_streams_need_no_logits():
    eng = _FakeEngine(5.0)
    chip_smoke.agree_or_tie("same", eng, [1, 2], [3, 4], [3, 4], 1e-3)
    assert eng.seen == []


def test_agree_or_tie_accepts_a_near_tie():
    eng = _FakeEngine(1e-4)
    chip_smoke.agree_or_tie("tie", eng, [1, 2], [3, 4, 5], [3, 9, 9], 1e-3)
    assert eng.seen == [[1, 2, 3]]  # the prefix up to the first difference


def test_agree_or_tie_rejects_a_clear_winner():
    with pytest.raises(AssertionError, match="clear winner"):
        chip_smoke.agree_or_tie("x", _FakeEngine(0.5), [1], [3], [4], 1e-3)


def test_mixed_requests_cover_the_range():
    reqs = chip_smoke.mixed_requests(1000, 12, seed=0)
    lens = [len(r.prompt) for r in reqs]
    assert len(reqs) == 12 and min(lens) >= 8 and max(lens) <= 300
    assert all(8 <= r.max_new_tokens <= 32 and r.temperature == 0.0
               for r in reqs)


def _fake_smi(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    smi = bin_dir / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    smi.chmod(0o755)
    return str(bin_dir) + os.pathsep + os.environ.get("PATH", "")


def test_chip_smoke_fails_on_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH=_fake_smi(tmp_path),
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", lone / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH=_fake_smi(tmp_path))
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=lone,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
