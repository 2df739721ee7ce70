"""The CLIP text tower and its BPE tokenizer (counterpart of yolo_tpu/nn/text_model.py:1-258).

- `SimpleTokenizer`: OpenAI CLIP's byte-level BPE. With CLIP's merge table (`bpe_simple_vocab_16e6.txt.gz`, named
  by `bpe_path` or YOLO_TPU_CLIP_BPE) it gives CLIP's ids; without one it falls back to byte-level tokens (the same
  special tokens and 77-token context), as the JAX package does. The pre-tokenizer splits as CLIP's pattern does
  (its specials, the English contractions, runs of letters, single digits, runs of anything else), by Unicode
  category from the standard library, since the `regex` module the JAX package uses may be missing.
- `CLIPTextEncoder`: the text transformer (pre-LN, causal mask, QuickGELU, the end-of-text token's feature,
  the projection), its initial tree drawn with the JAX package's numpy calls, the products in f32 with torch.
- `CLIPText` (tokenize + encode, its weights on a device; `load_torch` reads an OpenAI `clip` state dict's text
  keys) and `build_text_model`.
- `CLIPVisionEncoder` (the visual ViT, ViT-B/32 at 224² by default: class token, pre-LN, the same resblocks
  without a mask, the class token's feature through `proj`) and `CLIPModel` (both towers; `encode_image` resizes
  each crop's short side to 224 with cv2's bicubic and centre-crops it, as JAX does; `load_torch` reads a whole
  OpenAI `clip` state dict). FastSAM's text prompts score crops with them.

The towers run no kernel: plain torch, as JAX leaves them to XLA.
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from yolo_tpu_torch.device import resolve_device


@lru_cache()
def bytes_to_unicode() -> dict:
    """The reversible byte → printable character map of GPT-2 and CLIP."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    """NFC normalisation (in place of ftfy, as in the JAX package), HTML unescaped twice, stripped."""
    return html.unescape(html.unescape(unicodedata.normalize("NFC", text))).strip()


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


SPECIALS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _kind(ch: str) -> str:
    """'L' a letter, 'N' a number (Unicode categories L*, N*), ' ' white space, 'P' anything else."""
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else " " if ch.isspace() else "P"


def split_words(text: str) -> list:
    """CLIP's pre-tokenizer (`<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`,
    case-insensitive, found left to right): at each position the first alternative that matches, white space
    skipped."""
    out, i, n = [], 0, len(text)
    while i < n:
        low = text[i : i + 15].lower()
        hit = next((s for s in SPECIALS + CONTRACTIONS if low.startswith(s)), None)
        if hit:
            out.append(text[i : i + len(hit)])
            i += len(hit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # a run of letters, or of anything neither letter, number nor space; a number is one digit
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    """CLIP's byte-level BPE: CLIP's ids with the released merge table, byte-level ids without one (`has_merges`
    False), the context contract (77 tokens, start and end tokens, zero padding) the same either way."""

    CONTEXT = 77

    def __init__(self, bpe_path: str | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        bpe_path = bpe_path or os.getenv("YOLO_TPU_CLIP_BPE")
        merges: list = []
        if bpe_path and Path(bpe_path).exists():
            raw = Path(bpe_path).read_bytes()
            text = gzip.decompress(raw).decode("utf-8") if str(bpe_path).endswith(".gz") else raw.decode("utf-8")
            lines = text.split("\n")[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in lines if m]
            vocab.extend("".join(m) for m in merges)
        vocab.extend(SPECIALS)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.has_merges = bool(merges)
        self.cache = {s: s for s in SPECIALS}
        self.sot, self.eot = self.encoder[SPECIALS[0]], self.encoder[SPECIALS[1]]
        self.vocab_size = len(vocab)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda pair: self.bpe_ranks.get(pair, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list:
        ids: list = []
        for token in split_words(_whitespace_clean(_basic_clean(text)).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return bytearray([self.byte_decoder[c] for c in text]).decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        """Texts → (B, 77) int32 ids: start, the text's, end, zeros; a text too long is cut with the end token kept."""
        if isinstance(texts, str):
            texts = [texts]
        L = context_length or self.CONTEXT
        out = np.zeros((len(texts), L), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > L:
                ids = ids[: L - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out


def _resblock_params(rng, w: int) -> dict:
    """One resblock's initial subtree (JAX `_resblock_params`)."""

    def lin(ci, co):
        return {"weight": rng.normal(0, ci**-0.5, (co, ci)).astype(np.float32), "bias": np.zeros((co,), np.float32)}

    def ln():
        return {"weight": np.ones((w,), np.float32), "bias": np.zeros((w,), np.float32)}

    return {
        "attn": {"in_proj_weight": rng.normal(0, w**-0.5, (3 * w, w)).astype(np.float32),
                 "in_proj_bias": np.zeros((3 * w,), np.float32), "out_proj": lin(w, w)},
        "ln_1": ln(),
        "mlp": {"c_fc": lin(w, 4 * w), "c_proj": lin(4 * w, w)},
        "ln_2": ln(),
    }


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    """CLIP's LayerNorm (eps 1e-5, the biased variance)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["weight"] + p["bias"]


def _resblock(p: dict, x: torch.Tensor, nh: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pre-LN attention (causal where `mask` is given: the text tower), then the QuickGELU MLP, each with its
    residual (JAX `_resblock`, one body for both towers)."""
    B, L, w = x.shape
    hd = w // nh
    qkv = _ln(p["ln_1"], x) @ p["attn"]["in_proj_weight"].t() + p["attn"]["in_proj_bias"]
    q, k, v = (t.reshape(B, L, nh, hd).transpose(1, 2) for t in qkv.chunk(3, -1))
    logits = q @ k.transpose(-1, -2) / torch.sqrt(torch.tensor(float(hd), dtype=x.dtype))
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    att = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(B, L, w)
    x = x + att @ p["attn"]["out_proj"]["weight"].t() + p["attn"]["out_proj"]["bias"]
    h = _ln(p["ln_2"], x) @ p["mlp"]["c_fc"]["weight"].t() + p["mlp"]["c_fc"]["bias"]
    h = h * torch.sigmoid(1.702 * h)
    return x + h @ p["mlp"]["c_proj"]["weight"].t() + p["mlp"]["c_proj"]["bias"]


class CLIPTextEncoder:
    """CLIP's text tower (JAX CLIPTextEncoder); the defaults are ViT-B/32's (vocabulary 49408, context 77, width 512,
    12 layers, 8 heads, embedding 512)."""

    def __init__(self, vocab_size: int = 49408, context: int = 77, width: int = 512, layers: int = 12, heads: int = 8,
                 embed_dim: int = 512):
        self.vocab_size, self.context, self.width = vocab_size, context, width
        self.layers, self.heads, self.embed_dim = layers, heads, embed_dim

    def init(self, seed: int = 0) -> dict:
        """The JAX package's initial tree (OpenAI's names), drawn from np.random.default_rng(seed) in its order."""
        rng = np.random.default_rng(seed)
        w = self.width
        blocks = {str(i): _resblock_params(rng, w) for i in range(self.layers)}
        return {
            "token_embedding": {"weight": rng.normal(0, 0.02, (self.vocab_size, w)).astype(np.float32)},
            "positional_embedding": rng.normal(0, 0.01, (self.context, w)).astype(np.float32),
            "transformer": {"resblocks": blocks},
            "ln_final": {"weight": np.ones((w,), np.float32), "bias": np.zeros((w,), np.float32)},
            "text_projection": rng.normal(0, w**-0.5, (w, self.embed_dim)).astype(np.float32),
        }

    def encode_text(self, params: dict, tokens: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """(B, L) ids → (B, embed_dim) features in f32 on the params' device, unit norm if `normalize`; the pooled
        feature is the one at the largest id (the end token), as CLIP's."""
        B, L = tokens.shape
        x = params["token_embedding"]["weight"][tokens] + params["positional_embedding"][:L]
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        for i in range(self.layers):
            x = _resblock(params["transformer"]["resblocks"][str(i)], x, self.heads, causal)
        x = _ln(params["ln_final"], x)
        feats = x[torch.arange(B, device=x.device), tokens.argmax(-1)] @ params["text_projection"]
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True) if normalize else feats


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32).copy()).to(device)


class CLIPText:
    """Tokenize and encode (JAX CLIPText), the tower's f32 weights on `device` (None: the card). `params` holds the
    numpy tree (the seeded one, or `load_torch`'s)."""

    def __init__(self, width=512, layers=12, heads=8, embed_dim=512, bpe_path=None, seed=0, device=None):
        self.tokenizer = SimpleTokenizer(bpe_path)
        self.encoder = CLIPTextEncoder(width=width, layers=layers, heads=heads, embed_dim=embed_dim)
        self.device = resolve_device(device)
        self.set_params(self.encoder.init(seed))

    def set_params(self, params: dict) -> None:
        self.params = params
        self.weights = _to_device(params, self.device)

    def load_torch(self, path):
        """The text keys of an OpenAI `clip` checkpoint (a state dict; `visual.*` dropped), as JAX's `load_torch`."""
        from yolo_tpu_torch.nn.torch_import import load_torch_checkpoint, state_dict_to_params

        sd, _ = load_torch_checkpoint(path)
        self.set_params(state_dict_to_params({k: v for k, v in sd.items() if not k.startswith("visual.")}, self.params))
        return self

    def tokenize(self, texts) -> np.ndarray:
        return self.tokenizer(texts)

    @torch.no_grad()
    def encode_text(self, texts) -> torch.Tensor:
        """Texts (or (B, L) ids) → (B, embed_dim) unit-norm f32 features on the tower's device."""
        tokens = self.tokenizer(texts) if isinstance(texts, (str, list)) else texts
        return self.encoder.encode_text(self.weights, torch.as_tensor(np.asarray(tokens), dtype=torch.long).to(self.device))


def build_text_model(variant: str = "clip:ViT-B/32", bpe_path=None, device=None) -> CLIPText:
    """JAX `build_text_model`: "clip:<size>" and "mobileclip:b" / "mobileclip:blt" (the CLIP-layout text tower YOLOE
    ships with); MobileCLIP's s0 / s1 / s2 towers raise NotImplementedError, as in JAX. Unknown sizes take
    ViT-B/32's."""
    base, _, name = variant.partition(":")
    if base == "mobileclip" and name in ("s0", "s1", "s2"):
        raise NotImplementedError("mobileclip s0/s1/s2 text towers are not supported natively — use "
                                  "'mobileclip:b'/'mobileclip:blt' (CLIP-layout) or 'clip:ViT-B/32'")
    cfg = {"ViT-L/14": dict(width=768, layers=12, heads=12, embed_dim=768)}.get(
        name, dict(width=512, layers=12, heads=8, embed_dim=512))
    return CLIPText(**cfg, bpe_path=bpe_path, device=device)


class CLIPVisionEncoder:
    """CLIP's visual ViT (JAX CLIPVisionEncoder, OpenAI's names: conv1, class_embedding, positional_embedding, ln_pre,
    transformer.resblocks, ln_post, proj); the defaults are ViT-B/32's (224², patch 32, width 768, 12 layers, 12 heads,
    embedding 512). Images: (B, H, W, 3) RGB in [0, 1], normalised with CLIP's mean and std inside `encode_image`."""

    MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

    def __init__(self, image_size: int = 224, patch: int = 32, width: int = 768, layers: int = 12, heads: int = 12,
                 embed_dim: int = 512):
        self.image_size, self.patch, self.width = image_size, patch, width
        self.layers, self.heads, self.embed_dim = layers, heads, embed_dim
        self.grid = image_size // patch

    def init(self, seed: int = 0) -> dict:
        """The JAX package's initial tree, drawn from np.random.default_rng(seed) in its order (conv1 HWIO)."""
        rng = np.random.default_rng(seed)
        w = self.width

        def ln():
            return {"weight": np.ones((w,), np.float32), "bias": np.zeros((w,), np.float32)}

        blocks = {str(i): _resblock_params(rng, w) for i in range(self.layers)}
        return {
            "conv1": {"weight": rng.normal(0, 0.02, (self.patch, self.patch, 3, w)).astype(np.float32)},
            "class_embedding": rng.normal(0, w**-0.5, (w,)).astype(np.float32),
            "positional_embedding": rng.normal(0, 0.01, (self.grid**2 + 1, w)).astype(np.float32),
            "ln_pre": ln(),
            "transformer": {"resblocks": blocks},
            "ln_post": ln(),
            "proj": rng.normal(0, w**-0.5, (w, self.embed_dim)).astype(np.float32),
        }

    def encode_image(self, params: dict, images: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """(B, H, W, 3) RGB [0, 1] on the params' device → (B, embed_dim) f32 features, unit norm if `normalize`.
        `params` holds conv1 in torch's OIHW (the tree `_vision_to_device` installs)."""
        w = params["proj"]
        mean = torch.from_numpy(self.MEAN).to(w.device, w.dtype)
        std = torch.from_numpy(self.STD).to(w.device, w.dtype)
        x = ((images.to(w.dtype) - mean) / std).permute(0, 3, 1, 2)
        x = torch.nn.functional.conv2d(x, params["conv1"]["weight"], stride=self.patch)
        B, width = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        cls_tok = params["class_embedding"][None, None].expand(B, 1, width)
        x = _ln(params["ln_pre"], torch.cat([cls_tok, x], 1) + params["positional_embedding"])
        for i in range(self.layers):
            x = _resblock(params["transformer"]["resblocks"][str(i)], x, self.heads)
        feats = _ln(params["ln_post"], x[:, 0]) @ params["proj"]
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True) if normalize else feats


def _vision_to_device(tree: dict, device) -> dict:
    """The vision tree on `device` in f32, conv1 HWIO → OIHW."""
    out = _to_device(tree, device)
    out["conv1"]["weight"] = out["conv1"]["weight"].permute(3, 2, 0, 1).contiguous()
    return out


class CLIPModel:
    """Both CLIP towers (JAX CLIPModel): the text tower seeded with `seed`, the vision tower with `seed + 1`, their f32
    weights on `device` (None: the card). `vision_params` holds the vision tower's numpy tree."""

    def __init__(self, bpe_path=None, seed: int = 0, device=None, **vision_kw):
        self.text = CLIPText(bpe_path=bpe_path, seed=seed, device=device)
        self.device = self.text.device
        self.vision = CLIPVisionEncoder(**vision_kw)
        self.set_vision_params(self.vision.init(seed + 1))

    def set_vision_params(self, params: dict) -> None:
        self.vision_params = params
        self.vision_weights = _vision_to_device(params, self.device)

    def load_torch(self, path):
        """A whole OpenAI clip state dict: the text keys into the text tower, `visual.*` into the vision tower."""
        from yolo_tpu_torch.nn.torch_import import load_torch_checkpoint, state_dict_to_params
        from yolo_tpu_torch.utils import LOGGER

        if not self.text.tokenizer.has_merges:
            LOGGER.warning(
                "CLIP checkpoint loaded but the tokenizer is running byte-level FALLBACK ids "
                "(no BPE merge table) — text embeddings will be meaningless. Point YOLO_TPU_CLIP_BPE "
                "(or bpe_path=) at clip's bpe_simple_vocab_16e6.txt.gz.")
        sd, _ = load_torch_checkpoint(path)
        self.text.set_params(state_dict_to_params({k: v for k, v in sd.items() if not k.startswith("visual.")},
                                                  self.text.params))
        self.set_vision_params(state_dict_to_params(
            {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}, self.vision_params))
        return self

    def encode_text(self, texts) -> torch.Tensor:
        return self.text.encode_text(texts)

    def preprocess(self, images) -> np.ndarray:
        """RGB crops of any size (uint8 or [0, 1] floats) → (B, size, size, 3) f32 in [0, 1]: the short side resized to
        the tower's size with cv2's bicubic, then centre-cropped (CLIP's preprocess, as JAX does it)."""
        import cv2

        size = self.vision.image_size
        ims = []
        for im in images:
            im = np.asarray(im)
            if im.dtype == np.uint8:
                im = im.astype(np.float32) / 255.0
            if im.shape[:2] != (size, size):
                h0, w0 = im.shape[:2]
                s = size / min(h0, w0)
                im = cv2.resize(im, (max(size, round(w0 * s)), max(size, round(h0 * s))), interpolation=cv2.INTER_CUBIC)
                h1, w1 = im.shape[:2]
                top, left = (h1 - size) // 2, (w1 - size) // 2
                im = im[top : top + size, left : left + size]
            ims.append(im)
        return np.stack(ims).astype(np.float32)

    @torch.no_grad()
    def encode_image(self, images) -> torch.Tensor:
        """RGB crops → (B, embed_dim) unit-norm f32 features on the towers' device."""
        x = torch.from_numpy(self.preprocess(images)).to(self.device)
        return self.vision.encode_image(self.vision_weights, x)
