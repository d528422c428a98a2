"""The port's bench scripts on the CPU at a tiny size: the headline
(``scripts/bench.py``) against the root ``bench.py``'s program, its JSON
line, the flash sweep and the serving bench; and the files they write,
which must be new git-ignored paths under ``results/``, never a tracked
file of the JAX package's benches.
"""

import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from afldm_tpu_torch.scripts import bench, bench_flash_sweep, bench_serve

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KEYS = {"metric", "value", "unit", "vs_baseline"}


def test_headline_schedule_matches_bench_py(monkeypatch):
    """The root bench.py's scheduler, timesteps and ts_prev = ts - 20."""
    import bench as jax_bench
    from afldm_tpu.schedulers import DDIMScheduler
    seen = []
    real = DDIMScheduler.set_timesteps

    def spy(self, n):
        ts = real(self, n)
        seen.append((dict(self.config), np.asarray(ts)))
        return ts
    monkeypatch.setattr(DDIMScheduler, "set_timesteps", spy)
    jax_bench.build(n_steps=50)
    (cfg, want), = seen
    ts, ts_prev = bench.timesteps(50)
    np.testing.assert_array_equal(ts, want)
    np.testing.assert_array_equal(ts_prev, want - 20)
    port_cfg = bench.scheduler().config
    assert {k: port_cfg[k] for k in cfg if k in port_cfg} == {
        k: cfg[k] for k in cfg if k in port_cfg}
    short, short_prev = bench.timesteps(3)
    np.testing.assert_array_equal(short, want[:3])
    np.testing.assert_array_equal(short_prev, want[:3] - 20)


def _tiny_unet():
    from afldm_tpu_torch.models import UNet2DConfig
    return UNet2DConfig(
        sample_size=8, down_block_types=("AttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "AttnUpBlock2D"),
        block_out_channels=(32, 64), layers_per_block=1,
        attention_head_dim=8, norm_num_groups=8, alias_free=True)


@pytest.fixture
def tiny_bench(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "unet_config", _tiny_unet)
    monkeypatch.setattr(bench, "RESULTS", tmp_path)
    return tmp_path


def test_bench_main_prints_one_json_line(tiny_bench, capsys):
    # a cached CPU baseline: no subprocess
    bench.cpu_baseline_path().write_text(json.dumps(
        {"cpu_steps_per_s": 2.0, "n_steps": 50}))
    line = bench.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == KEYS
    assert line["metric"] == "af_unet_denoise_steps_per_s_ffhq256"
    assert line["unit"] == "steps/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 2.0)
    hist = bench.history_path().read_text().splitlines()
    assert len(hist) == 1 and json.loads(hist[0])["vs_best_prior"] is None


def test_bench_measure_details(tiny_bench):
    d = bench.measure(n_steps=2, repeats=1, device="cpu",
                      return_details=True)
    assert d["gflop_per_step"] > 0 and d["steps_per_s"] > 0
    assert d["mfu_vs_67tflops_f32"] == pytest.approx(
        d["tflop_per_s"] / 67.0)
    assert d["device"] == "cpu"


def test_bench_history_flags_a_drop(tiny_bench, capsys):
    path = bench.history_path()
    path.write_text(json.dumps({"steps_per_s": 10.0}) + "\n{truncated\n")
    bench.record_history(5.0)
    assert "DRIFT WARNING" in capsys.readouterr().err
    last = json.loads(path.read_text().splitlines()[-1])
    assert last["vs_best_prior"] == pytest.approx(0.5)


def test_flash_sweep_cpu_rows(tmp_path):
    out = tmp_path / "rows.jsonl"
    rows = bench_flash_sweep.main(
        ["--device", "cpu", "--tokens", "128", "--dim", "8", "--heads", "1",
         "--batch", "1", "--frames", "2", "--iters", "1", "--out", str(out)])
    assert [(r["kind"], r["op"]) for r in rows] == [
        ("sweep", "sdpa"), ("sweep", "sdpa2"), ("probe", "sdpa")]
    probe = rows[-1]
    for k in ("flash_ms", "dots_only_ms", "stream_only_ms"):
        assert np.isfinite(probe[k]) and probe[k] > 0
    assert probe["softmax_share"] == pytest.approx(
        1 - probe["dots_only_ms"] / probe["flash_ms"])
    assert len(out.read_text().splitlines()) == 3


def test_bench_serve_tiny_cpu(tmp_path):
    out = tmp_path / "serve.json"
    res = bench_serve.main(["--tiny", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert res["serial"]["requests"] == 2
    assert res["concurrent"]["requests"] == 2
    assert res["microbatching_speedup"] > 0


def _written_paths():
    return [bench.cpu_baseline_path(), bench.history_path(),
            bench.extra_path(), bench_flash_sweep.OUT, bench_serve.OUT,
            Path(bench_flash_sweep.parse_args([]).out),
            Path(bench_serve.parse_args([]).out)]


@pytest.mark.parametrize("path", _written_paths(),
                         ids=lambda p: Path(p).name)
def test_bench_outputs_are_new_ignored_files(path):
    path = Path(path).resolve()
    assert path.parent == REPO / "results"
    assert "_torch" in path.name
    if (REPO / ".git").exists():
        rel = str(path.relative_to(REPO))
        tracked = subprocess.run(["git", "ls-files", "--error-unmatch", rel],
                                 cwd=REPO, capture_output=True)
        assert tracked.returncode != 0, f"{rel} is tracked"
        ignored = subprocess.run(["git", "check-ignore", "-q", rel],
                                 cwd=REPO)
        assert ignored.returncode == 0, f"{rel} is not git-ignored"
