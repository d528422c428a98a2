"""The port's sampler service (``afldm_tpu_torch/serve.py``) against the
JAX ``SamplerService`` and on its own: images at the same seeds with the
same weights, microbatching of concurrent requests, bucket padding,
oversize requests, and the HTTP surface over a real server on 127.0.0.1;
the serving CLI's ``build_pipeline``.

Tolerance: images within 1e-4 of their scale against JAX (rounding over
two UNet passes and the decode); batched against alone within 1e-5
(another batch size sums in another order).
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu_torch.serve import SamplerService, serve
from test_torch_harness import assert_rel_close, load_port, numpy_init

torch.set_num_threads(1)

STEPS = 2


def _jax_draw(service, num_images, seed):
    """The JAX service's latents for ``seed``, NCHW."""
    cfg = service.pipeline.unet.config
    lat = jax.random.normal(jax.random.PRNGKey(seed),
                            (num_images, cfg.sample_size, cfg.sample_size,
                             cfg.in_channels), jnp.float32)
    return torch.from_numpy(np.array(lat)).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def pipelines():
    """The tiny serving pipeline of ``bench_serve --tiny`` on both sides
    with the same weights."""
    from afldm_tpu.models import (AutoencoderKL, AutoencoderKLConfig,
                                  UNet2DConfig, UNet2DModel)
    from afldm_tpu.pipelines import LDMPipeline as JPipe
    from afldm_tpu.schedulers import DDIMScheduler as JDDIM
    from afldm_tpu_torch.scripts.bench_serve import build_pipeline
    tp = build_pipeline(tiny=True, device="cpu")
    uc, vc = tp.unet.config, tp.vae.config
    ju = UNet2DModel(UNet2DConfig.from_diffusers(uc.to_dict()))
    jv = AutoencoderKL(AutoencoderKLConfig.from_diffusers(vc.to_dict()))
    up = numpy_init(ju, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32))
    vp = numpy_init(jv, jnp.zeros((1, 16, 16, 3)), seed=1)
    load_port(tp.unet, up)
    load_port(tp.vae, vp)
    jp = JPipe(jv, vp, ju, up, JDDIM.from_config(tp.scheduler.config))
    return jp, tp


def test_service_matches_jax_service(pipelines, monkeypatch):
    from afldm_tpu.serve import SamplerService as JService
    jp, tp = pipelines
    monkeypatch.setattr(SamplerService, "_draw", _jax_draw)
    js, ts = JService(jp, batch_window_ms=1.0), SamplerService(
        tp, batch_window_ms=1.0)
    try:
        for seed in (3, 11):
            want = js.sample(1, STEPS, seed=seed)["images"]
            got = ts.sample(1, STEPS, seed=seed)["images"]
            assert got.shape == want.shape == (1, 16, 16, 3)
            assert_rel_close(got, want, 1e-4, f"seed {seed}")
    finally:
        js.close()
        ts.close()


def test_seed_gives_the_same_image(pipelines):
    _, tp = pipelines
    svc = SamplerService(tp, batch_window_ms=1.0)
    try:
        a, b, c = (svc.sample(1, STEPS, seed=s)["images"] for s in (7, 7, 8))
        np.testing.assert_array_equal(a, b)
        assert np.abs(a - c).max() > 0
        assert torch.equal(svc._draw(2, 5)[1:], svc._draw(2, 5)[1:])
    finally:
        svc.close()


def test_concurrent_requests_batch_and_pad(pipelines):
    """Three concurrent single-image requests share one pass, padded to
    bucket 4; each image equals the one served alone."""
    _, tp = pipelines
    svc = SamplerService(tp, batch_window_ms=300.0, max_batch=8)
    try:
        ref = {s: svc.sample(1, STEPS, seed=s)["images"] for s in range(3)}
        base = dict(svc.stats, by_bucket=dict(svc.stats["by_bucket"]))
        with ThreadPoolExecutor(max_workers=3) as ex:
            futs = {s: ex.submit(svc.sample, 1, STEPS, s) for s in range(3)}
            out = {s: f.result(timeout=120) for s, f in futs.items()}
        for s in range(3):
            np.testing.assert_allclose(out[s]["images"], ref[s], atol=1e-5)
        assert svc.stats["batches"] - base["batches"] == 1
        assert svc.stats["requests"] - base["requests"] == 3
        assert svc.stats["padded_slots"] - base["padded_slots"] == 1
        assert svc.stats["by_bucket"]["4"] == 1
        assert sorted(o["batched_with"] for o in out.values()) == [2, 2, 2]
    finally:
        svc.close()


def test_unequal_step_counts_do_not_merge(pipelines):
    _, tp = pipelines
    svc = SamplerService(tp, batch_window_ms=300.0, max_batch=8)
    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(svc.sample, 1, steps, 0) for steps in (1, 2)]
            for f in futs:
                assert f.result(timeout=120)["batched_with"] == 0
        assert svc.stats["batches"] == 2
    finally:
        svc.close()


def test_oversize_request_raises(pipelines):
    _, tp = pipelines
    svc = SamplerService(tp, max_batch=4)
    try:
        assert svc.buckets == [1, 2, 4]
        with pytest.raises(ValueError, match="max_batch"):
            svc.sample(num_images=5, num_inference_steps=STEPS)
    finally:
        svc.close()


def test_errors_reach_every_waiter(pipelines):
    _, tp = pipelines
    svc = SamplerService(tp, batch_window_ms=1.0)
    try:
        with pytest.raises(ValueError):  # more steps than timesteps
            svc.sample(1, 5000, seed=0)
    finally:
        svc.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_surface(pipelines):
    _, tp = pipelines
    server, svc = serve(tp, port=0, batch_window_ms=1.0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        assert _get(f"{base}/healthz") == (200, {"ok": True})
        req = urllib.request.Request(
            f"{base}/sample", method="POST",
            data=json.dumps({"num_images": 2, "num_inference_steps": STEPS,
                             "seed": 4}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["shape"] == [2, 16, 16, 3]
        assert body["batched_with"] == 0 and body["latency_s"] > 0
        imgs = np.load(io.BytesIO(base64.b64decode(body["images_b64"])))
        np.testing.assert_array_equal(
            imgs, svc.sample(2, STEPS, seed=4)["images"])
        code, stats = _get(f"{base}/stats")
        assert code == 200 and stats["requests"] == 2
        assert stats["by_bucket"] == {"2": 2}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=60)
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        th.join(timeout=10)
    assert not th.is_alive()


def test_serve_cli_builds_pipelines(tmp_path):
    from afldm_tpu_torch.scripts import serve_ldm
    pipe = serve_ldm.build_pipeline(serve_ldm.parse_args(
        ["--tiny", "--device", "cpu"]))
    assert pipe.unet.config.sample_size == 8
    assert pipe.vae.config.downsample_ratio == 2
    from afldm_tpu_torch.ops import ideal_lpf
    try:
        pipe = serve_ldm.build_pipeline(serve_ldm.parse_args(
            ["--tiny", "--device", "cpu", "--af_precision", "high"]))
        assert ideal_lpf.af_precision() == "high"
        assert pipe.unet.config.sample_size == 8
    finally:
        ideal_lpf.set_af_precision("highest")
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        serve_ldm.build_pipeline(serve_ldm.parse_args(
            ["--pipeline_dir", str(tmp_path), "--device", "cpu"]))


def test_load_pipeline_reads_a_saved_pipeline(tmp_path, pipelines):
    """``load_pipeline`` on a directory in ``LDMTrainer.save_pipeline``'s
    layout gives back the saved weights (the EMA UNet where saved)."""
    from afldm_tpu_torch.pipelines import load_pipeline
    from afldm_tpu_torch.train import save_checkpoint
    _, tp = pipelines
    for name, cfg in (("unet_config.json", tp.unet.config.to_dict()),
                      ("vae_config.json", tp.vae.config.to_dict()),
                      ("scheduler_config.json", tp.scheduler.config)):
        (tmp_path / name).write_text(json.dumps(cfg))
    ema = {k: v + 1 for k, v in tp.unet.state_dict().items()}
    save_checkpoint(str(tmp_path), 3, {"unet": tp.unet.state_dict(),
                                       "unet_ema": ema,
                                       "vae": tp.vae.state_dict()})
    pipe = load_pipeline(str(tmp_path), device="cpu")
    for k, v in pipe.unet.state_dict().items():
        torch.testing.assert_close(v, ema[k], atol=0, rtol=0)
    for k, v in pipe.vae.state_dict().items():
        torch.testing.assert_close(v, tp.vae.state_dict()[k], atol=0, rtol=0)
    assert pipe.scheduler.config == tp.scheduler.config
