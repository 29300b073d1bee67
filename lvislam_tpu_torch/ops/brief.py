"""Binary descriptors, Hamming matching and bag-of-words scoring — port of
``lvislam_tpu.ops.brief`` (the pose_graph package's DBoW2 / DVision
machinery, `keyframe.cpp:37-110`, `loop_detector.cpp:55-135`).

Descriptors are ±1 float32 vectors, so Hamming distances, word assignment
and the database query are matmuls: hamming(a, b) = (256 - a·b) / 2. The
JAX module computes these matmuls outside any Pallas kernel, and so does
this one (``torch.matmul``). Their results are integers (sums of ±1 and 0
products) and stay exact in float32 only with full-f32 matmuls: TF32 would
round the 256-term sums. ``lvislam_tpu_torch/__init__.py`` turns TF32 off
for the whole package.

The vocabulary helpers (``make_vocabulary``, ``train_vocabulary``,
``save_vocabulary``, ``load_vocabulary``) are host-side numpy, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from . import image as imops

N_BITS = 256
PATCH_HALF = 24


def brief_pattern(seed: int = 7) -> np.ndarray:
    """(N_BITS, 4) sampling pattern (x1, y1, x2, y2), gaussian around center
    (the DVision generator's distribution)."""
    rng = np.random.default_rng(seed)
    pat = np.clip(rng.normal(0, PATCH_HALF / 2.5, size=(N_BITS, 4)), -PATCH_HALF, PATCH_HALF)
    return pat.astype(np.float32)


_PATTERN = brief_pattern()


def describe(img: torch.Tensor, kps: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(K, N_BITS) descriptors in {-1, +1} (0 for invalid keypoints) of
    keypoints `kps` (K, 2) in image `img` (H, W), sampled on its 5-tap
    Gaussian blur."""
    blur = imops._sep_conv(img, imops._GAUSS5)
    pat = torch.as_tensor(_PATTERN, device=img.device)
    i1 = imops.bilinear_sample(blur, kps[:, None, :] + pat[None, :, 0:2])
    i2 = imops.bilinear_sample(blur, kps[:, None, :] + pat[None, :, 2:4])
    bits = torch.where(i1 < i2, 1.0, -1.0)
    return torch.where(valid[:, None], bits, 0.0)


def hamming_matmul(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(K1, K2) Hamming distances via one matmul on ±1 descriptors."""
    return (N_BITS - d1 @ d2.T) / 2.0


def match(d1: torch.Tensor, v1: torch.Tensor, d2: torch.Tensor, v2: torch.Tensor,
          max_hamming: float = 80.0):
    """Best match of each row (`searchByBRIEFDes`, Hamming < 80). Returns
    (idx (K1,) int32, ok (K1,)); ties go to the lower index."""
    ham = hamming_matmul(d1, d2)
    ham = torch.where(v2[None, :], ham, torch.full_like(ham, float("inf")))
    idx = torch.argmin(ham, dim=1)
    best = torch.take_along_dim(ham, idx[:, None], dim=1)[:, 0]
    return idx.to(torch.int32), v1 & (best < max_hamming)


def make_vocabulary(n_words: int = 1024, seed: int = 11) -> np.ndarray:
    """(V, N_BITS) ±1 centroid descriptors — the untrained fallback for the
    DBoW2 brief_k10L6 tree."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n_words, N_BITS)) > 0.5, 1.0, -1.0).astype(np.float32)


def train_vocabulary(
    desc: np.ndarray,  # (N, N_BITS) ±1 training descriptors
    n_words: int = 1024,
    iters: int = 12,
    seed: int = 11,
    image_ids: np.ndarray | None = None,  # (N,) source image of each desc
) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-means ("k-majority") vocabulary training with k-means++
    seeding on Hamming distance and farthest-descriptor repair of empty
    words. Returns (vocab (V, N_BITS) ±1 float32, idf (V,) float32); the
    idf weights are DBoW2's log(N_images / N_i) when `image_ids` is given
    (ones otherwise)."""
    desc = np.asarray(desc, np.float32)
    N = desc.shape[0]
    rng = np.random.default_rng(seed)
    V = min(n_words, N)
    centers = [desc[rng.integers(N)]]
    d2 = None
    for _ in range(V - 1):
        ham = (N_BITS - desc @ centers[-1]) / 2.0
        d2 = ham if d2 is None else np.minimum(d2, ham)
        p = d2 * d2
        s = p.sum()
        if s <= 0:
            centers.append(desc[rng.integers(N)])
            continue
        centers.append(desc[rng.choice(N, p=p / s)])
    C = np.stack(centers)
    for _ in range(iters):
        sim = desc @ C.T
        a = np.argmax(sim, axis=1)
        onehot_sums = np.zeros((V, N_BITS), np.float32)
        np.add.at(onehot_sums, a, desc)
        counts = np.bincount(a, minlength=V)
        newC = np.where(onehot_sums >= 0.0, 1.0, -1.0).astype(np.float32)
        empty = counts == 0
        if empty.any():
            best = sim[np.arange(N), a]
            far = np.argsort(best)[: int(empty.sum())]
            newC[empty] = desc[far]
        if np.array_equal(newC, C):
            C = newC
            break
        C = newC
    if n_words > V:  # fewer descriptors than words: pad with random words
        C = np.concatenate([C, make_vocabulary(n_words - V, seed=seed + 1)], axis=0)
    idf = np.ones(n_words, np.float32)
    if image_ids is not None:
        image_ids = np.asarray(image_ids)
        a = np.argmax(desc @ C.T, axis=1)
        n_img = max(len(np.unique(image_ids)), 1)
        pairs = np.unique(np.stack([a, image_ids]), axis=1)
        ni = np.bincount(pairs[0], minlength=n_words).astype(np.float64)
        idf = np.log(n_img / np.maximum(ni, 1.0)).astype(np.float32)
        idf = np.maximum(idf, 1e-3)
    return C.astype(np.float32), idf


def save_vocabulary(path: str, vocab: np.ndarray, idf: np.ndarray) -> None:
    """Bit-packed vocabulary file: ±1 words as packed bits + f32 idf."""
    v = np.asarray(vocab)
    bits = np.packbits((v > 0).astype(np.uint8), axis=1)
    np.savez_compressed(path, bits=bits, n_bits=np.int32(v.shape[1]),
                        idf=np.asarray(idf, np.float32))


def load_vocabulary(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of `save_vocabulary` -> (vocab ±1 f32, idf f32)."""
    z = np.load(path)
    bits = np.unpackbits(z["bits"], axis=1)[:, : int(z["n_bits"])]
    vocab = np.where(bits > 0, 1.0, -1.0).astype(np.float32)
    return vocab, z["idf"].astype(np.float32)


def bow_vector(desc: torch.Tensor, valid: torch.Tensor, vocab: torch.Tensor,
               idf: torch.Tensor | None = None) -> torch.Tensor:
    """L1-normalized word histogram of a descriptor set ((V,) float), tf·idf
    before normalization when `idf` is given. Word counts go through
    ``bincount`` (integer counts: exact, and deterministic on the card)."""
    sim = desc @ vocab.T  # (K, V)
    sim = torch.where(valid[:, None], sim, torch.full_like(sim, -float("inf")))
    word = torch.argmax(sim, dim=1)
    V = vocab.shape[0]
    slot = torch.where(valid, word, torch.full_like(word, V))
    hist = torch.bincount(slot, minlength=V + 1)[:V].to(desc.dtype)
    if idf is not None:
        hist = hist * idf
    return hist / torch.clamp(torch.sum(hist), min=1e-9)


def bow_scores(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """L1 similarity of a query bag against every stored bag: for
    L1-normalized bags, DBoW2's 1 - 0.5 |q - d|_1 == sum(min(q, d))."""
    return torch.sum(torch.minimum(query[None, :], database), dim=1)
