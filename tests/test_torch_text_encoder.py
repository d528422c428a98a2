"""The port's CLIP text encoder against transformers' Flax and torch CLIP
text models and the JAX package's ``TextEncoder``, on the CPU at the tiny
config of ``tests/test_convert_sd.py`` (vocabulary 99, width 16, 2 layers
of 2 heads, 12 positions): hidden states within 2e-5 (f32 rounding of the
same products in another order; measured ~1e-6). The tokenizers: the hash
fallback gives the JAX package's ids, and the BPE gives transformers'
``CLIPTokenizer``'s ids exactly, on a vocabulary of every byte, its
word-final form and a few merges.
"""

import json

import numpy as np
import jax
import pytest
import torch
from flax.traverse_util import flatten_dict

from afldm_tpu_torch.models import text_encoder as TE
from afldm_tpu_torch.models.convert import text_encoder_from_flax

torch.set_num_threads(1)

ATOL = 2e-5
TINY = dict(vocab_size=99, hidden_size=16, intermediate_size=32,
            num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=12, projection_dim=16)


def _ids(rng, n=3, length=12, vocab=99):
    return rng.integers(0, vocab, (n, length)).astype(np.int32)


def test_flax_weights_carry_across(rng):
    """A tiny FlaxCLIPTextModel's parameters through
    ``text_encoder_from_flax`` load strictly and give its hidden states,
    at the full length and at a shorter one."""
    from transformers import CLIPTextConfig, FlaxCLIPTextModel
    jm = FlaxCLIPTextModel(CLIPTextConfig(**TINY), seed=0)
    pm = TE.CLIPTextModel(TE.CLIPTextConfig.from_dict(TINY))
    pm.load_state_dict(text_encoder_from_flax(flatten_dict(jm.params)),
                       strict=True)
    run = jax.jit(lambda ids: jm(input_ids=ids).last_hidden_state)
    for length in (12, 5):
        ids = _ids(rng, length=length)
        want = np.asarray(run(ids))
        with torch.no_grad():
            got = pm(torch.from_numpy(ids).long()).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.fixture(scope="module")
def saved_clip(tmp_path_factory):
    """A tiny torch CLIPTextModel saved by transformers (safetensors), with
    a persistent ``position_ids`` buffer added as older checkpoints carry
    it, in a second directory as a ``.bin``."""
    from safetensors.torch import load_file
    from transformers import CLIPTextConfig, CLIPTextModel
    torch.manual_seed(0)
    tm = CLIPTextModel(CLIPTextConfig(**TINY)).eval()
    d = tmp_path_factory.mktemp("clip")
    tm.save_pretrained(d)
    old = tmp_path_factory.mktemp("clip_bin")
    (old / "config.json").write_text((d / "config.json").read_text())
    state = load_file(str(d / "model.safetensors"))
    state["text_model.embeddings.position_ids"] = torch.arange(12)[None]
    torch.save(state, old / "pytorch_model.bin")
    return tm, d, old


def test_saved_torch_model_matches_jax_text_encoder(saved_clip, rng):
    """The same directory read by the port and by the JAX package's
    ``TextEncoder`` (through transformers' ``from_pt``)."""
    from afldm_tpu.models.text_encoder import TextEncoder as JaxTextEncoder
    tm, d, old = saved_clip
    ids = _ids(rng)
    want = np.asarray(JaxTextEncoder(pretrained_dir=str(d)).encode(ids))
    with torch.no_grad():
        ref = tm(input_ids=torch.from_numpy(ids).long()).last_hidden_state
    np.testing.assert_allclose(ref.numpy(), want, atol=ATOL)
    for path in (d, old):
        got = TE.TextEncoder(pretrained_dir=str(path), device="cpu")
        assert got.tokenizer is None and got.max_length == 12
        np.testing.assert_allclose(got.encode(ids).numpy(), want, atol=ATOL)


def test_hash_tokenizer_matches_jax():
    from afldm_tpu.models.text_encoder import TextEncoder as JaxTextEncoder
    jte = object.__new__(JaxTextEncoder)  # no Flax model: tokenize only
    jte.max_length, jte._tokenizer = 77, None
    prompts = ["a photo of a Cat", "", "  two   spaces  ",
               " ".join(f"w{i}" for i in range(100))]
    np.testing.assert_array_equal(TE.hash_tokenize(prompts, 77),
                                  jte.tokenize(prompts))


def _write_vocab(path):
    """Every byte character and its word-final form, a few merges, the two
    specials; ``vocab.json`` and ``merges.txt`` as CLIP ships them."""
    chars = list(TE._bytes_to_unicode().values())
    merges = [("h", "e"), ("he", "l"), ("hel", "l"), ("hell", "o</w>"),
              ("w", "o"), ("wo", "r"), ("wor", "l"), ("worl", "d</w>"),
              ("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "f"),
              ("i", "t"), ("'", "s</w>")]
    toks = (chars + [c + "</w>" for c in chars] + [a + b for a, b in merges]
            + ["<|startoftext|>", "<|endoftext|>"])
    path.mkdir(exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(toks)}, ensure_ascii=False),
        encoding="utf-8")
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges),
        encoding="utf-8")


PROMPTS = ["hello world", "Hello, World!! the cafe", "it's  the\tTHE 2024x",
           "naïve café — über ½", "hello<|endoftext|>world", "日本語 text.",
           "a" * 5 + " " + " ".join(["hello"] * 90), ""]


def test_bpe_tokenizer_matches_transformers(tmp_path):
    from transformers import CLIPTokenizer
    _write_vocab(tmp_path)
    want = CLIPTokenizer(str(tmp_path / "vocab.json"),
                         str(tmp_path / "merges.txt"))(
        PROMPTS, padding="max_length", max_length=77, truncation=True,
        return_tensors="np")["input_ids"]
    got = TE.CLIPTokenizer(str(tmp_path))(PROMPTS, 77)
    np.testing.assert_array_equal(got, want)
    vocab = TE.CLIPTokenizer(str(tmp_path)).encoder
    assert list(got[0][:4]) == [vocab["<|startoftext|>"], vocab["hello</w>"],
                                vocab["world</w>"], vocab["<|endoftext|>"]]


def test_text_encoder_reads_its_tokenizer_or_raises(tmp_path):
    """A tokenizer directory is read (the port's ids, then the encoder's
    states of them); one that cannot be read raises, where the JAX package
    falls back to the hash tokenizer."""
    _write_vocab(tmp_path / "tok")
    n_vocab = len(json.loads((tmp_path / "tok" / "vocab.json").read_text(
        encoding="utf-8")))
    d = tmp_path / "te"
    d.mkdir()
    cfg = TE.CLIPTextConfig.from_dict(dict(TINY, vocab_size=n_vocab))
    (d / "config.json").write_text(json.dumps(cfg.to_dict()))
    torch.save(TE.CLIPTextModel(cfg).init_random_(
        torch.Generator().manual_seed(0)).state_dict(),
        d / "pytorch_model.bin")
    te = TE.TextEncoder(pretrained_dir=str(d), device="cpu",
                        tokenizer_dir=str(tmp_path / "tok"))
    ids = te.tokenize(["hello world"])
    assert ids.shape == (1, 12) and ids[0, 0] == te.tokenizer.bos
    out = te.encode(["hello world"])
    assert out.shape == (1, 12, 16) and torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), te.encode(ids).numpy())
    with pytest.raises(FileNotFoundError):
        TE.TextEncoder(pretrained_dir=str(d), device="cpu",
                       tokenizer_dir=str(tmp_path / "missing"))


def test_random_text_encoder_is_vit_l_from_the_seed(monkeypatch):
    """Without a checkpoint: ViT-L/14's text config (123.1M parameters),
    weights from the seed; the card unless a device is given."""
    full = TE.CLIPTextModel(TE.CLIPTextConfig())
    assert sum(p.numel() for p in full.parameters()) == 123060480
    assert TE.CLIPTextConfig().to_dict() == TE.CLIP_VIT_L_TEXT_CONFIG
    small = TE.CLIPTextConfig(**TINY)
    monkeypatch.setattr(TE, "CLIPTextConfig", lambda: small)
    a, b = (TE.TextEncoder(seed=3, device="cpu") for _ in range(2))
    c = TE.TextEncoder(seed=4, device="cpu")
    wa = a.model.text_model.embeddings.token_embedding.weight
    assert torch.equal(wa, b.model.text_model.embeddings.token_embedding
                       .weight)
    assert not torch.equal(wa, c.model.text_model.embeddings
                           .token_embedding.weight)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.TextEncoder(seed=3)
