"""Synthetic evaluation/training datasets mirroring the paper's two suites.

* **MMDU-like** (Liu et al. 2024d): multi-turn, multi-image dialogues where
  images are stitched at *sentence level* ("IMAGE#1, IMAGE#2. Can you
  describe these images...").
* **Sparkles-like** (Huang et al. 2024): images woven in at *word level*
  ("Can you link the celebration in IMAGE#1 and the race in IMAGE#2?").

Media content is synthetic: each "image" is a deterministic random patch
embedding (seeded by its id) from the stub frontend — the modality
carve-out.  What matters for the reproduction is the *prompt structure*
(where media KV lands and how often prefixes diverge), which these
generators match.  (The port's own copy of the JAX package's
``data/datasets.py``, the training pipeline included, plus the audio
frames that whisper's training batches need.)
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Iterator, List

import numpy as np

from repro_torch.core.segments import Prompt, Segment, media_segment, text_segment
from repro_torch.data.tokenizer import ByteTokenizer

_WORDS = ("the a scenic mountain river photo shows detail people building "
          "compare describe landmark colors style differences light travel "
          "plan visit famous ticket crowd history guide map route "
          "celebration race event link relation").split()

SYSTEM_PROMPT = "You are a helpful multimodal assistant."


def _sentence(rng, lo=4, hi=10) -> str:
    n = int(rng.integers(lo, hi))
    return " ".join(rng.choice(_WORDS, n)) + "."


def image_embeds(media_id: str, length: int, d_model: int) -> np.ndarray:
    """Deterministic stub 'ViT' output for a media id.

    Seeded with crc32, not ``hash()``: string hashing is randomized per
    process (PYTHONHASHSEED), which would make the same media id carry
    different content in different pytest/bench runs.
    """
    seed = zlib.crc32(media_id.encode()) % (2 ** 31)
    r = np.random.default_rng(seed)
    return (r.standard_normal((length, d_model)) * 0.02).astype(np.float32)


@dataclasses.dataclass
class DialogueSample:
    prompt: Prompt
    media_ids: List[str]
    reference: str   # "gold" continuation text (for loss-based scoring)


def _mk_prompt(rng, tok: ByteTokenizer, d_model: int, media_len: int,
               n_images: int, style: str, user_id: str,
               include_system: bool, conv_id: int) -> DialogueSample:
    segs: List[Segment] = []
    if include_system:
        segs.append(text_segment(tok.encode(SYSTEM_PROMPT, bos=True),
                                 kind="system"))
    media_ids = [f"img-{conv_id}-{i}" for i in range(n_images)]

    # the paper's core scenario: the OPENING WORDS differ between requests
    opening = _sentence(rng, 3, 7)
    segs.append(text_segment(tok.encode(" " + opening)))

    if style == "mmdu":
        # sentence-level stitching: block of images, then the question
        for mid in media_ids:
            segs.append(media_segment(
                mid, image_embeds(mid, media_len, d_model)))
        segs.append(text_segment(tok.encode(
            " Can you describe these images in detail? " + _sentence(rng))))
    else:
        # sparkles: word-level weaving
        for i, mid in enumerate(media_ids):
            segs.append(text_segment(tok.encode(f" {_sentence(rng, 2, 5)} ")))
            segs.append(media_segment(
                mid, image_embeds(mid, media_len, d_model)))
        segs.append(text_segment(tok.encode(" " + _sentence(rng))))

    return DialogueSample(Prompt(segs, user_id=user_id), media_ids,
                          reference=_sentence(rng, 8, 16))


def make_dialogues(*, n: int, n_images: int, d_model: int,
                   media_len: int = 32, style: str = "mmdu",
                   seed: int = 0, user_id: str = "u0",
                   include_system: bool = True) -> List[DialogueSample]:
    rng = np.random.default_rng(seed)
    tok = ByteTokenizer()
    return [_mk_prompt(rng, tok, d_model, media_len, n_images, style,
                       user_id, include_system, conv_id=i)
            for i in range(n)]


# ---------------------------------------------------------------------------
# training pipeline (tokens + media for the train example / train_4k shape)
# ---------------------------------------------------------------------------

def train_batches(*, batch: int, seq: int, vocab: int, d_model: int,
                  media_fraction: float = 0.25, media_len: int = 16,
                  seed: int = 0) -> Iterator[dict]:
    """Infinite stream of causal-LM batches with interleaved media spans.

    Deterministic synthetic text with learnable structure (repeated n-gram
    process) so a small model's loss visibly drops within a few hundred
    steps.  The same numpy draws as the JAX package's: a seed gives the
    same batches in both.
    """
    rng = np.random.default_rng(seed)
    # order-1 markov over a small alphabet embedded in the byte range
    k = 64
    trans = rng.dirichlet(np.ones(k) * 0.1, size=k)
    while True:
        toks = np.zeros((batch, seq), np.int32)
        state = rng.integers(0, k, size=batch)
        for t in range(seq):
            nxt = np.array([rng.choice(k, p=trans[s]) for s in state])
            toks[:, t] = nxt + 8
            state = nxt
        media_mask = np.zeros((batch, seq), bool)
        media = np.zeros((batch, seq, d_model), np.float32)
        for b in range(batch):
            if rng.random() < media_fraction:
                off = int(rng.integers(0, max(seq - media_len, 1)))
                media_mask[b, off:off + media_len] = True
                media[b, off:off + media_len] = (
                    rng.standard_normal((media_len, d_model)) * 0.02)
        labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)],
                                axis=1)
        yield {"tokens": toks, "labels": labels,
               "media_embeds": media, "media_mask": media_mask}


def with_audio(batches: Iterator[dict], *, encoder_seq: int, d_model: int,
               seed: int = 0) -> Iterator[dict]:
    """``batches`` with seeded audio frames added to each: ``audio_embeds``
    (B, encoder_seq, d_model) fp32, N(0, 0.02), the stub frontend's frame
    embeddings that an encoder-decoder's loss encodes (``train_batches``
    carries none, so whisper cannot train on it alone)."""
    rng = np.random.default_rng(seed)
    for b in batches:
        n = b["tokens"].shape[0]
        frames = rng.standard_normal((n, encoder_seq, d_model),
                                     dtype=np.float32) * np.float32(0.02)
        yield dict(b, audio_embeds=frames)
