"""CLIP text encoder of the SD-family pipelines and trainers, in plain
torch: the transformer of Hugging Face's ``CLIPTextModel`` under its
parameter names (``text_model.embeddings.token_embedding.weight``, ...,
``text_model.final_layer_norm.*``), so that a saved ``text_encoder/``
directory loads with ``strict=True``, and CLIP's byte-level BPE tokenizer
over ``vocab.json`` and ``merges.txt``. Counterpart of
``afldm_tpu/models/text_encoder.py``, which wraps transformers'
``FlaxCLIPTextModel``; nothing here needs ``transformers``.

Attention is ``torch.matmul`` and softmax under the causal mask, as the
JAX side computes it outside any Pallas kernel. Without a checkpoint the
weights are drawn from a seed (ViT-L/14's text config); without a
tokenizer directory prompts go through the JAX package's crc32 hash
tokenizer. A tokenizer directory that cannot be read raises: the JAX
package falls back to the hash tokenizer there.
"""

import json
import math
import os
import unicodedata
import zlib
from dataclasses import asdict, dataclass, fields
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

BOS, EOS = 49406, 49407  # the hash tokenizer's start and end/pad ids
WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


@dataclass
class CLIPTextConfig:
    """The fields of transformers' ``CLIPTextConfig`` the text transformer
    reads; the defaults are ViT-L/14's (``CLIP_VIT_L_TEXT_CONFIG``)."""
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768

    @classmethod
    def from_dict(cls, cfg: dict):
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in names})

    def to_dict(self):
        return asdict(self)


CLIP_VIT_L_TEXT_CONFIG = CLIPTextConfig().to_dict()

_ACTS = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
         "gelu": nn.functional.gelu}


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(d, d) for _ in range(4))

    def forward(self, x, mask):
        n, length, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(n, length, self.heads, hd).transpose(1, 2)
        q = split(self.q_proj(x)) * (hd ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        s = torch.matmul(q, k.transpose(-1, -2)).masked_fill(mask,
                                                             float("-inf"))
        out = torch.matmul(torch.softmax(s, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(n, length, d))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _ACTS[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = _Attention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """``forward(input_ids) -> last_hidden_state`` (N, L, hidden_size),
    L <= max_position_embeddings, under the causal mask."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids):
        tm = self.text_model
        length = input_ids.shape[1]
        mask = torch.ones(length, length, dtype=torch.bool,
                          device=input_ids.device).triu(1)
        x = tm.embeddings(input_ids)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Embeddings and linear weights normal with std 0.02, zero biases,
        unit layer-norm scales, drawn from ``generator`` in parameter
        order."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "layer_norm" in name:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        return self


def read_state_dict(directory: str, names=WEIGHT_FILES) -> dict:
    """The state dict in the first of ``names`` found in ``directory``:
    ``.safetensors`` through the ``safetensors`` package (raises when it
    is not installed), anything else through ``torch.load`` with
    ``weights_only=True``."""
    for name in names:
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            continue
        if name.endswith(".safetensors"):
            try:
                from safetensors.torch import load_file
            except ImportError as e:
                raise ImportError(
                    f"{path}: reading .safetensors needs the safetensors "
                    f"package, which is not installed; save the weights as "
                    f"a .bin (torch.save of the state dict) instead") from e
            return load_file(path)
        return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no weight file in {directory!r} (looked for "
                            f"{', '.join(names)})")


def load_clip_text_model(directory: str) -> CLIPTextModel:
    """A ``text_encoder/`` directory (``config.json`` and
    ``model.safetensors`` or ``pytorch_model.bin``, as transformers saves
    ``CLIPTextModel``), loaded strictly; the persistent
    ``text_model.embeddings.position_ids`` buffer of older checkpoints is
    dropped."""
    with open(os.path.join(directory, "config.json")) as f:
        cfg = CLIPTextConfig.from_dict(json.load(f))
    state = read_state_dict(directory)
    state.pop("text_model.embeddings.position_ids", None)
    model = CLIPTextModel(cfg)
    model.load_state_dict(state, strict=True)
    return model


# -- tokenizers ----------------------------------------------------------------

def hash_tokenize(prompts, max_length: int) -> np.ndarray:
    """The JAX package's fallback: BOS, then each lower-cased
    whitespace-split word as ``crc32(word) % 49000 + 300``, then EOS
    padding; (N, max_length) int64."""
    ids = np.full((len(prompts), max_length), EOS, np.int64)
    for i, p in enumerate(prompts):
        ids[i, 0] = BOS
        for j, w in enumerate(p.lower().split()[: max_length - 2]):
            ids[i, j + 1] = (zlib.crc32(w.encode()) % 49000) + 300
    return ids


@lru_cache
def _bytes_to_unicode():
    """CLIP's reversible map of the 256 bytes onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_cjk(cp: int) -> bool:
    return any(a <= cp <= b for a, b in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


def _basic_clean(text: str) -> str:
    """The text normalisation of transformers' ``CLIPTokenizer`` without
    ``ftfy`` (its ``BasicTokenizer(strip_accents=False,
    do_split_on_punc=False)``): control characters dropped, whitespace
    made spaces, CJK characters spaced, NFC, lower case, single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        if ch in " \t\n\r" or cat == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or cat.startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(w.lower() for w in text.split())


def _pre_tokenize(text: str) -> list:
    """CLIP's pattern ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll
    |'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case-insensitive), scanned
    with unicodedata categories: the ``regex`` package is not needed."""
    def cat(ch):
        return unicodedata.category(ch)[0]
    words, i, n = [], 0, len(text)
    low = text.lower()
    while i < n:
        ch = text[i]
        hit = next((s for s in _SPECIALS + _CONTRACTIONS
                    if low.startswith(s, i)), None)
        if hit:
            words.append(text[i:i + len(hit)])
            i += len(hit)
        elif cat(ch) == "L":
            j = i + 1
            while j < n and cat(text[j]) == "L":
                j += 1
            words.append(text[i:j])
            i = j
        elif cat(ch) == "N":
            words.append(ch)
            i += 1
        elif ch.isspace():
            i += 1
        else:
            j = i + 1
            while (j < n and cat(text[j]) not in "LN"
                   and not text[j].isspace()):
                j += 1
            words.append(text[i:j])
            i = j
    return words


class CLIPTokenizer:
    """CLIP's byte-level BPE over a directory's ``vocab.json`` and
    ``merges.txt``: ids of ``<|startoftext|>``, the prompt truncated to
    ``max_length - 2`` tokens, ``<|endoftext|>``, then ``<|endoftext|>``
    padding to ``max_length``, as transformers' ``CLIPTokenizer`` gives
    them with ``padding="max_length", truncation=True``."""

    def __init__(self, directory: str):
        with open(os.path.join(directory, "vocab.json"),
                  encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(os.path.join(directory, "merges.txt"),
                  encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.ranks = {tuple(m.split()): r for r, m in enumerate(lines)}
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self.cache = {s: s for s in _SPECIALS}

    def bpe(self, token: str) -> list:
        if token in self.cache:
            return self.cache[token].split(" ")
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            first, second = min(pairs, key=lambda p: self.ranks.get(
                p, math.inf))
            if (first, second) not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = " ".join(word)
        return list(word)

    def tokens(self, text: str) -> list:
        byte_map = _bytes_to_unicode()
        out = []
        for w in _pre_tokenize(_basic_clean(text)):
            out.extend(self.bpe("".join(byte_map[b]
                                        for b in w.encode("utf-8"))))
        return out

    def __call__(self, prompts, max_length: int) -> np.ndarray:
        ids = np.full((len(prompts), max_length), self.eos, np.int64)
        for i, p in enumerate(prompts):
            toks = [self.encoder.get(t, self.eos)
                    for t in self.tokens(p)][: max_length - 2]
            row = [self.bos] + toks + [self.eos]
            ids[i, :len(row)] = row
        return ids


class TextEncoder:
    """``encode(prompts) -> (N, max_length, hidden)``: the CLIP text
    transformer of ``pretrained_dir`` (a ``text_encoder/`` directory), or
    of ``config`` (default ViT-L/14's) with weights drawn from ``seed``, on
    ``device`` (the card unless given). Prompts are tokenized by the BPE of
    ``tokenizer_dir`` (default: ``pretrained_dir`` when it holds a
    ``vocab.json``), else by the hash tokenizer."""

    def __init__(self, pretrained_dir: Optional[str] = None, seed: int = 0,
                 device=None, tokenizer_dir: Optional[str] = None,
                 config: Optional[CLIPTextConfig] = None):
        from ..pipelines.loading import resolve_device
        self.device = resolve_device(device)
        if pretrained_dir:
            model = load_clip_text_model(pretrained_dir)
        else:
            model = CLIPTextModel(config or CLIPTextConfig()).init_random_(
                torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.max_length = model.config.max_position_embeddings
        if tokenizer_dir is None and pretrained_dir and os.path.exists(
                os.path.join(pretrained_dir, "vocab.json")):
            tokenizer_dir = pretrained_dir
        self.tokenizer = CLIPTokenizer(tokenizer_dir) if tokenizer_dir \
            else None

    def tokenize(self, prompts) -> np.ndarray:
        if isinstance(prompts, str):
            prompts = [prompts]
        if self.tokenizer is not None:
            return self.tokenizer(list(prompts), self.max_length)
        return hash_tokenize(prompts, self.max_length)

    @torch.no_grad()
    def encode(self, prompts) -> torch.Tensor:
        """prompts: a string, a list of strings or token ids (N, L)."""
        if isinstance(prompts, (list, tuple, str)):
            ids = self.tokenize(prompts)
        else:
            ids = prompts
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                              device=self.device)
        return self.model(ids)
