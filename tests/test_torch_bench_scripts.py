"""The port's counterparts of the JAX package's nine bench scripts on the
CPU at a tiny size: each runs through its ``main(argv)`` and its rows carry
the JAX script's keys, with the renames, additions and drops its docstring
documents (the JAX scripts' keys are written out here with the lines they
come from). ``roofline_denoise``'s five ablated full-width UNets have the
JAX models' parameter counts (``jax.eval_shape`` of their init, no
compute; the port's built on the meta device). Each script's default
output is a new git-ignored ``results/*_torch*`` file.
"""

import importlib
import json
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afldm_tpu_torch.scripts import (bench_attention, bench_filtered_act,
                                     bench_flash_bwd_sweep,
                                     bench_interp_denoise, bench_pipelines,
                                     bench_sdpa2, bench_train,
                                     roofline_denoise, run_all_benchmarks)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = (bench_attention, bench_filtered_act, bench_sdpa2,
           bench_flash_bwd_sweep, bench_train, roofline_denoise,
           bench_interp_denoise, bench_pipelines, run_all_benchmarks)


def _keys(jax_keys, renames=None, added=(), dropped=()):
    """The port's keys: the JAX keys renamed, less the dropped, plus the
    added."""
    renames = renames or {}
    return ({renames.get(k, k) for k in jax_keys if k not in dropped}
            | set(added))


def _finite(row):
    return all(np.isfinite(v) for v in row.values()
               if isinstance(v, float))


# scripts/bench_attention.py:85 (grad line) and :89-99 (the table)
ATTN_JAX = ("shape", "xla", "flash", "speedup", "max_err")
ATTN_GRAD_JAX = ("grad_xla", "grad_flash")
ATTN_RENAMES = {"xla": "library_ms", "flash": "sdpa_ms",
                "grad_xla": "grad_library_ms", "grad_flash": "grad_sdpa_ms"}


@pytest.mark.parametrize("grad", [False, True])
def test_bench_attention_rows(monkeypatch, tmp_path, capsys, grad):
    monkeypatch.setattr(bench_attention, "SHAPES",
                        [(1, 2, 64, 64, 8), (2, 1, 100, 77, 20)])
    out = tmp_path / "rows.jsonl"
    rows = bench_attention.main(["--device", "cpu", "--iters", "1",
                                 "--out", str(out)]
                                + (["--grad"] if grad else []))
    want = _keys(ATTN_JAX + (ATTN_GRAD_JAX if grad else ()), ATTN_RENAMES,
                 ["sdpa_eager_ms", "dtype", "device"]
                 + (["grad_sdpa_eager_ms"] if grad else []))
    assert [set(r) for r in rows] == [want, want]
    assert all(_finite(r) and r["max_err"] < 1e-5 for r in rows)
    assert [r["shape"] for r in rows] == [[1, 2, 64, 64, 8],
                                          [2, 1, 100, 77, 20]]
    assert len(out.read_text().splitlines()) == 2
    assert "| (B, heads, Lq, Lk, D) float32 |" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--block_q", "512"],
                                  ["--block_k", "1024"]])
def test_bench_attention_refuses_other_blocks(argv):
    with pytest.raises(SystemExit, match="one tile"):
        bench_attention.main(["--device", "cpu", *argv])


def test_bench_attention_takes_the_kernel_tile(monkeypatch, tmp_path):
    monkeypatch.setattr(bench_attention, "SHAPES", [(1, 1, 64, 64, 8)])
    rows = bench_attention.main(["--device", "cpu", "--iters", "1",
                                 "--dtype", "bfloat16", "--block_q", "64",
                                 "--block_k", "128",
                                 "--out", str(tmp_path / "r.jsonl")])
    assert rows[0]["dtype"] == "bfloat16"


# scripts/bench_filtered_act.py:92 (grad line) and :103-116 (the table)
FACT_JAX = ("shape", "mode", "xla_matmul", "xla_spectral", "pallas",
            "speedup_vs_best_xla", "max_err")
FACT_GRAD_JAX = ("grad_pallas", "grad_xla_matmul")
FACT_RENAMES = {"pallas": "fused_ms", "xla_matmul": "plain_matmul_ms",
                "xla_spectral": "fft_ms",
                "speedup_vs_best_xla": "speedup_vs_best_plain",
                "grad_pallas": "grad_fused_ms",
                "grad_xla_matmul": "grad_plain_matmul_ms"}


@pytest.mark.parametrize("argv,grad", [
    (["--grad"], True),
    (["--dtype", "bfloat16", "--af_precision", "high"], False)])
def test_bench_filtered_act_rows(monkeypatch, tmp_path, capsys, argv, grad):
    # a plane of the channel kernel's size and one of the banded chain's
    monkeypatch.setattr(bench_filtered_act, "SHAPES",
                        [(1, 8, 8, 3), (1, 68, 72, 2)])
    rows = bench_filtered_act.main(["--device", "cpu", "--iters", "1",
                                    "--out", str(tmp_path / "r.jsonl"),
                                    *argv])
    want = _keys(FACT_JAX + (FACT_GRAD_JAX if grad else ()), FACT_RENAMES,
                 ["dtype", "af_precision", "device"])
    assert [set(r) for r in rows] == [want, want]
    assert [r["mode"] for r in rows] == ["plane", "banded"]
    assert all(_finite(r) for r in rows)
    assert "| shape | mode | plain_matmul | fft | fused |" in \
        capsys.readouterr().out
    from afldm_tpu_torch.ops import af_precision
    assert af_precision() == "highest"  # the level is reset


# scripts/bench_sdpa2.py:93-97
SDPA2_JAX = ("shape", "dtype", "unfused_ms", "fused_ms", "speedup",
             "max_abs_diff")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bench_sdpa2_row(tmp_path, dtype):
    out = tmp_path / "r.jsonl"
    row = bench_sdpa2.main(["--device", "cpu", "--frames", "3", "--tokens",
                            "64", "--dim", "8", "--heads", "2", "--iters",
                            "1", "--dtype", dtype, "--out", str(out)])
    assert set(row) == _keys(SDPA2_JAX, added=["device"])
    assert _finite(row) and row["dtype"] == dtype
    assert json.loads(out.read_text()) == row


# scripts/bench_flash_bwd_sweep.py:106-112 (the summary row of :120-128
# compares block pairs, of which the port has one: dropped)
BWD_JAX = ("kind", "bq", "bk", "dtype", "shape", "iters", "grad_ms",
           "fwd_ms", "bwd_ms")


def test_bench_flash_bwd_sweep_rows(tmp_path):
    out = tmp_path / "bwd.json"
    argv = ["--device", "cpu", "--batch", "1", "--heads", "2", "--tokens",
            "64", "--dim", "8", "--iters", "1", "--out", str(out)]
    rows = [bench_flash_bwd_sweep.main(argv + ["--dtype", dt])
            for dt in ("bf16", "f32", "bf16")]
    for row, tile in zip(rows, ((64, 128), (128, 64), (64, 128))):
        assert set(row) == _keys(BWD_JAX, added=["device"])
        assert (row["bq"], row["bk"]) == tile and _finite(row)
        assert row["bwd_ms"] == pytest.approx(row["grad_ms"] - row["fwd_ms"])
    # one row a dtype: a rerun replaces its dtype's row, keeps the other's
    saved = json.loads(out.read_text())
    assert [r["dtype"] for r in saved["rows"]] == ["f32", "bf16"]
    assert saved["args"]["dtype"] == "bf16"


# scripts/bench_train.py:111-128
TRAIN_JAX = ("workload", "batch", "mixed_precision", "gradient_checkpointing",
             "remat_policy", "af_precision", "af_models", "shift_loss",
             "steps_per_s", "images_per_s", "final_loss", "program_gflop",
             "tflop_per_s", "mfu_vs_197tflops_bf16")


@pytest.fixture
def tiny_train(monkeypatch):
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs(tiny=True)
    monkeypatch.setattr(bench_train, "model_configs",
                        lambda: (vcfg, ucfg, scfg))


@pytest.mark.parametrize("argv,mfu", [
    ([], "mfu_vs_67tflops_f32"),
    (["--mixed_precision", "bf16", "--naive", "--no_shift_loss"],
     "mfu_vs_989tflops_bf16")])
def test_bench_train_row(tiny_train, tmp_path, argv, mfu):
    row = bench_train.main(["--device", "cpu", "--batch", "2",
                            "--resolution", "64", "--steps", "1",
                            "--out", str(tmp_path / "r.jsonl"), *argv])
    assert set(row) == _keys(TRAIN_JAX, {"mfu_vs_197tflops_bf16": mfu},
                             ["first_step_s", "peak_memory_gib", "device"])
    assert _finite(row) and row["program_gflop"] > 0
    assert row["peak_memory_gib"] is None  # no device memory on the CPU
    assert row["af_models"] == ("--naive" not in argv)
    assert row[mfu] == pytest.approx(
        row["tflop_per_s"] / (989.0 if "bf16" in mfu else 67.0))


def test_bench_train_flops_scale_with_the_batch(tiny_train, monkeypatch):
    """FLOPs are counted once at batch 1 and scaled: the count at batch 1
    times 2 is the batch-2 step's own count, so the step is linear in the
    batch."""
    from torch.utils.flop_counter import FlopCounterMode
    args = bench_train.parse_args(["--batch", "2", "--resolution", "64"])
    tr = bench_train.build_trainer(args, 2, "cpu", "no")
    counter = FlopCounterMode(display=False)
    with counter:
        tr.training_step(0, {"input": bench_train.images(2, 64)})
    assert bench_train.step_flops(args) == counter.get_total_flops()


# scripts/roofline_denoise.py:96-150 (``cost_analysis_error`` only when
# XLA's cost analysis fails: the port has none)
ROOF_JAX = ("full_af_step_ms", "gflop_per_step", "mfu_vs_197tflops_bf16",
            "full_af_step_prec_high_ms", "full_af_step_prec_default_ms",
            "no_attention_ms", "naive_resample_plain_act_ms",
            "af_resample_plain_act_ms", "naive_resample_filtered_act_ms",
            "conv_core_ms", "attention_share", "af_machinery_share",
            "filtered_act_share", "af_resample_share", "batch", "dtype")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_roofline_denoise_row(monkeypatch, tmp_path, dtype):
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    monkeypatch.setattr(roofline_denoise, "unet_json",
                        lambda: load_configs(tiny=True)[0])
    out = tmp_path / "roof.json"
    row = roofline_denoise.main(["--device", "cpu", "--batch", "2",
                                 "--iters", "1", "--repeats", "1",
                                 "--dtype", dtype, "--out", str(out)])
    mfu = "mfu_vs_989tflops_bf16" if dtype == "bf16" else \
        "mfu_vs_67tflops_f32"
    added = ["device"] + (["full_af_step_bf16_split_ms"]
                          if dtype == "bf16" else [])
    assert set(row) == _keys(ROOF_JAX, {"mfu_vs_197tflops_bf16": mfu},
                             added)
    assert _finite(row) and json.loads(out.read_text()) == row
    base = row["full_af_step_ms"]
    assert row["attention_share"] == pytest.approx(
        1 - row["no_attention_ms"] / base)
    assert row["af_resample_share"] == pytest.approx(
        (row["af_resample_plain_act_ms"]
         - row["naive_resample_plain_act_ms"]) / base)
    from afldm_tpu_torch.ops.ideal_lpf import af_bf16_split, af_precision
    assert af_precision() == "highest" and not af_bf16_split()


def _jax_build(cfg_json, alias_free=True, add_attention=True,
               filtered_act=None):
    """The JAX script's ``build`` config (scripts/roofline_denoise.py
    :47-66), written out again."""
    from afldm_tpu.models import UNet2DConfig
    cfg_d = dict(cfg_json)
    if not add_attention:
        cfg_d["down_block_types"] = [
            t.replace("AttnDownBlock2D", "DownBlock2D")
            for t in cfg_d["down_block_types"]]
        cfg_d["up_block_types"] = [
            t.replace("AttnUpBlock2D", "UpBlock2D")
            for t in cfg_d["up_block_types"]]
        cfg_d["add_attention"] = False
    if filtered_act is not None:
        cfg_d["filtered_act"] = filtered_act
    return UNet2DConfig.from_diffusers(cfg_d, alias_free=alias_free)


@pytest.mark.parametrize("name", sorted(roofline_denoise.ABLATIONS))
def test_roofline_ablations_match_jax_parameter_counts(name):
    from afldm_tpu.models import UNet2DModel as JaxUNet
    from afldm_tpu_torch.models import UNet2DModel
    kw = roofline_denoise.ABLATIONS[name]
    cfg_json = roofline_denoise.unet_json()
    jcfg = _jax_build(cfg_json, **kw)
    s = jcfg.sample_size
    shapes = jax.eval_shape(JaxUNet(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, s, s, jcfg.in_channels)),
                            jnp.zeros((1,), jnp.int32))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes))
    cfg = roofline_denoise.ablation(cfg_json, **kw)
    with torch.device("meta"):
        got = sum(p.numel() for p in UNet2DModel(cfg).parameters())
    assert got == want
    assert (cfg.alias_free, cfg.add_attention, cfg.filtered_act) == (
        jcfg.alias_free, jcfg.add_attention, jcfg.filtered_act)


# scripts/bench_interp_denoise.py:125-131: one program, so the arms' keys
# become one and the keys comparing them are gone
INTERP_JAX = ("frames", "steps", "dtype", "latent", "unfused_s", "fused_s",
              "speedup", "unfused_ms_per_step", "fused_ms_per_step",
              "checksum_rel_diff")
INTERP_RENAMES = {"unfused_s": "seconds", "fused_s": "seconds",
                  "unfused_ms_per_step": "ms_per_step",
                  "fused_ms_per_step": "ms_per_step"}


def test_bench_interp_denoise_row(tmp_path):
    row = bench_interp_denoise.main(["--tiny", "--device", "cpu",
                                     "--frames", "3", "--steps", "2",
                                     "--iters", "1", "--dtype", "f32",
                                     "--out", str(tmp_path / "r.jsonl")])
    assert set(row) == _keys(INTERP_JAX, INTERP_RENAMES,
                             ["checksum", "store_s", "device"],
                             ["speedup", "checksum_rel_diff"])
    assert _finite(row) and row["latent"] == 16
    assert row["ms_per_step"] == pytest.approx(row["seconds"] / 2 * 1e3)


def test_bench_interp_denoise_has_no_fused_knob():
    """The SD UNet's interp pass runs two ``sdpa`` calls and a blend in
    both packages; the port's script has no switch between arms."""
    args = bench_interp_denoise.parse_args([])
    assert not any("fuse" in k for k in vars(args))


# scripts/bench_pipelines.py:94-190
PIPE_JAX = {"resolution": None, "steps": None, "attn": None,
            "video_editing": ("frames", "first_call_s", "seconds",
                              "frames_per_s", "finite"),
            "interpolation": ("frames", "first_call_s", "seconds",
                              "frames_per_s", "finite"),
            "i2sb_sr": ("first_call_s", "seconds", "images_per_s",
                        "finite"),
            "normal_yoso_sweep": ("shift_steps", "first_call_s", "seconds",
                                  "estimates_per_s", "finite")}


def test_bench_pipelines_result(monkeypatch, tmp_path):
    from afldm_tpu_torch.models import (AutoencoderKLConfig,
                                        UNet2DConditionConfig, UNet2DConfig)
    from afldm_tpu_torch.scripts import image_interpolation, shift_ldm_ffhq
    sd_u, sd_v, _ = image_interpolation.load_configs(tiny=True)
    ffhq_u = shift_ldm_ffhq.load_configs(tiny=True)[0]

    def tiny(res):
        return (UNet2DConditionConfig.from_diffusers(
                    dict(sd_u, sample_size=res // 8), alias_free=True),
                AutoencoderKLConfig.from_diffusers(sd_v),
                UNet2DConfig.from_diffusers(ffhq_u, alias_free=True))
    monkeypatch.setattr(bench_pipelines, "model_configs", tiny)
    out = tmp_path / "p.json"
    res = bench_pipelines.main(["--device", "cpu", "--frames", "2",
                                "--resolution", "64", "--steps", "2",
                                "--interp_frames", "2", "--out", str(out)])
    assert set(res) == set(PIPE_JAX) | {"device"}
    for k, keys in PIPE_JAX.items():
        if keys is not None:
            assert set(res[k]) == set(keys), k
            assert res[k]["finite"] is True and _finite(res[k]), k
    assert json.loads(out.read_text()) == res


def test_bench_pipelines_refuses_xla_attention():
    with pytest.raises(SystemExit, match="no switch"):
        bench_pipelines.parse_args(["--attn", "xla"])


# scripts/run_all_benchmarks.py:74-210
RUN_ALL_JAX = {"_provenance": ("ffhq_shift", "i2sb_sr_shift", "normal_shift",
                               "video_editing", "interpolation"),
               "ffhq_shift": ("mean_psnr", "psnrs", "seconds", "weights"),
               "i2sb_sr_shift": ("mean_psnr", "seconds", "weights"),
               "normal_shift": ("mean_psnr", "seconds", "weights"),
               "video_editing": ("frames", "finite", "seconds", "weights"),
               "interpolation": ("frames", "finite", "seconds", "weights")}


def test_run_all_benchmarks_summary(tmp_path):
    out = tmp_path / "bench.json"
    out.write_text(json.dumps({"flagship_ab_256px": {"kept": True}}))
    res = run_all_benchmarks.main(["--tiny", "--device", "cpu", "--steps",
                                   "2", "--shift_steps", "2", "--out",
                                   str(out)])
    assert set(res) == set(RUN_ALL_JAX) | {"_device"}
    for k, keys in RUN_ALL_JAX.items():
        assert set(res[k]) == set(keys), k
    assert set(res["_provenance"].values()) == {"random"}
    assert len(res["ffhq_shift"]["psnrs"]) == 2
    assert (res["video_editing"]["frames"], res["interpolation"]["frames"]) \
        == (5, 3)
    assert res["video_editing"]["finite"] and res["interpolation"]["finite"]
    merged = json.loads(out.read_text())
    assert merged["flagship_ab_256px"] == {"kept": True}  # sibling kept


def test_run_all_benchmarks_provenance(tmp_path):
    conv = tmp_path / "conv"
    conv.mkdir()
    (conv / "provenance.json").write_text(json.dumps(
        {"provenance": "converted"}))
    assert run_all_benchmarks.provenance(None) == "random"
    assert run_all_benchmarks.provenance(str(conv)) == "converted"
    assert run_all_benchmarks.provenance(str(tmp_path)) == "trained"


@pytest.mark.parametrize("mod", SCRIPTS,
                         ids=lambda m: m.__name__.split(".")[-1])
def test_default_outputs_are_new_ignored_files(mod):
    path = Path(mod.parse_args([]).out).resolve()
    assert path == Path(mod.OUT).resolve()
    assert path.parent == REPO / "results" and "_torch" in path.name
    if (REPO / ".git").exists():
        rel = str(path.relative_to(REPO))
        tracked = subprocess.run(["git", "ls-files", "--error-unmatch", rel],
                                 cwd=REPO, capture_output=True)
        assert tracked.returncode != 0, f"{rel} is tracked"
        ignored = subprocess.run(["git", "check-ignore", "-q", rel],
                                 cwd=REPO)
        assert ignored.returncode == 0, f"{rel} is not ignored"


def test_chip_smoke_runs_every_bench_script():
    """chip_smoke's phase 39 names each of the nine scripts once, with
    arguments its parser takes and launch counters that exist; phase 38's
    rows are the probes' bf16 counters."""
    from afldm_tpu_torch import kernels
    from test_torch_kernels_build import _chip_smoke
    smoke = _chip_smoke()
    assert sorted(n for n, _, _ in smoke.BENCH_SCRIPTS) == sorted(
        m.__name__.split(".")[-1] for m in SCRIPTS)
    for name, argv, needed in smoke.BENCH_SCRIPTS:
        mod = importlib.import_module(f"afldm_tpu_torch.scripts.{name}")
        mod.parse_args([*argv, "--out", "x.json"])
        assert needed and set(needed) <= set(kernels.LAUNCHES), name
    assert smoke.PROBE_BF16_ROWS == ("flash_probe_dots/bf16",
                                     "flash_probe_stream/bf16")
    assert set(smoke.PROBE_BF16_ROWS) <= set(kernels.LAUNCHES)
