"""The CLIP text tower of the port against the JAX package's on the CPU: the pre-tokenizer against JAX's `regex`
pattern, the token ids (byte fallback and a BPE merge table) on ASCII, unicode, long (cut at 77 with the end token
kept) and empty texts, a narrow tower (width 64, 2 layers) and `build_text_model()`'s full tower (width 512, 12
layers, vocabulary 49408) on their seeded trees, and `load_torch` of an OpenAI-layout state dict the test writes.

Tolerances, stated again at each test: token ids and trees exact; features 1e-5."""

import gzip

import jax
import numpy as np
import pytest
import torch

from yolo_tpu.nn import text_model as JTM
from yolo_tpu_torch.nn import text_model as PTM

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)
from tests.test_torch_pose import _same_tree

FEAT = 1e-5
TEXTS = {
    "ascii": ["a photo of a cat", "aircraft", "Don't stop: it's 3.14 o'clock, isn't it?!", "x-ray & <|endoftext|> tag"],
    "unicode": ["café déjà vu", "日本の飛行機", "naïve ΣΊΣΥΦΟΣ 🚀 ½ ²", "é  spaced\ttabs\nlines", "&amp; &lt;b&gt;"],
    "long": ["word " * 200, "abcdefghij" * 30],
    "empty": ["", "   ", "\n"],
}


@pytest.mark.parametrize("kind", list(TEXTS))
def test_pre_tokenizer_matches_jax_pattern(kind):
    """`split_words` gives the pieces of JAX's `regex` pattern (CLIP's), found left to right, on the cleaned and
    lower-cased texts."""
    tok = JTM.SimpleTokenizer()
    for t in TEXTS[kind]:
        text = JTM._whitespace_clean(JTM._basic_clean(t)).lower()
        assert PTM.split_words(text) == tok._re.findall(text), t


def _merges(path):
    """A small BPE merge table in CLIP's gzip format (a header line, then one merge a line)."""
    lines = ["#version: test", "a t", "h e", "c a", "ca t</w>", "e r", "p h", "ph o", "pho t", "o </w>", "i r", "ai r"]
    path.write_bytes(gzip.compress("\n".join(lines).encode()))
    return str(path)


@pytest.mark.parametrize("merges", [False, True], ids=["bytes", "bpe"])
@pytest.mark.parametrize("kind", list(TEXTS))
def test_token_ids_match_jax(kind, merges, tmp_path):
    """(B, 77) int32 ids equal to JAX's: the start token, the text's, the end token, zeros; a long text cut at 77 with
    the end token last. Byte-level fallback (no merge table), and a small merge table through CLIP's BPE loop."""
    path = _merges(tmp_path / "bpe.txt.gz") if merges else None
    j, p = JTM.SimpleTokenizer(path), PTM.SimpleTokenizer(path)
    assert p.has_merges == j.has_merges == merges and p.vocab_size == j.vocab_size
    want, got = j(TEXTS[kind]), p(TEXTS[kind])
    assert got.dtype == want.dtype == np.int32 and got.shape == (len(TEXTS[kind]), 77)
    np.testing.assert_array_equal(got, want)
    if kind == "long":
        assert (got[:, -1] == p.eot).all()
    if kind == "empty":
        assert (got[:, :2] == [p.sot, p.eot]).all() and not got[:, 2:].any()
    if merges and kind == "ascii":
        assert p.encoder["cat</w>"] in got[0]


def _tower_pair(**kw):
    j, p = JTM.CLIPText(**kw), PTM.CLIPText(**kw, device="cpu")
    _same_tree(p.params, jax.tree_util.tree_map(np.asarray, j.params))
    return j, p


@pytest.mark.parametrize("full", [False, True], ids=["narrow", "full"])
def test_tower_matches_jax(full, two_threads):
    """The seeded tree bit for bit and the unit-norm features within 1e-5 of JAX's: a narrow tower (width 64, 2 layers,
    4 heads) on four texts, and `build_text_model()`'s full ViT-B/32 tower on one prompt."""
    if full:
        j, p = JTM.build_text_model(), PTM.build_text_model(device="cpu")
        _same_tree(p.params, jax.tree_util.tree_map(np.asarray, j.params))
        texts = ["a photo of an aircraft"]
    else:
        j, p = _tower_pair(width=64, layers=2, heads=4, embed_dim=32, seed=3)
        texts = TEXTS["ascii"]
    want = np.asarray(jax.jit(j.encoder.encode_text)(j.params, j.tokenize(texts)))
    got = p.encode_text(texts).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_load_torch_reads_an_openai_state_dict(tmp_path, two_threads):
    """A state dict in OpenAI CLIP's layout (the text keys of a width-64 tower drawn from seed 9, a `visual.*` key
    beside them), saved with torch.save, loads into both packages' towers (built from seed 3) to the same tree, and
    their features agree within 1e-5; the visual key is dropped."""
    src = PTM.CLIPTextEncoder(width=64, layers=2, heads=4, embed_dim=32).init(9)

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            key = f"{prefix}.{k}" if prefix else k
            out.update(flat(v, key) if isinstance(v, dict) else {key: torch.from_numpy(np.asarray(v))})
        return out

    sd = {**flat(src), "visual.proj": torch.zeros(8, 8)}
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    j, p = _tower_pair(width=64, layers=2, heads=4, embed_dim=32, seed=3)
    j.load_torch(str(path))
    p.load_torch(str(path))
    _same_tree(p.params, src)
    _same_tree(p.params, jax.tree_util.tree_map(np.asarray, j.params))
    texts = TEXTS["ascii"][:2]
    want = np.asarray(jax.jit(j.encoder.encode_text)(j.params, j.tokenize(texts)))
    np.testing.assert_allclose(p.encode_text(texts).numpy(), want, rtol=0, atol=FEAT)
