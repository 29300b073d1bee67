"""Train the BRIEF bag-of-words vocabulary from synthetic renders: the port
of ``scripts/train_vocab.py``.

Usage:
  python -m lvislam_tpu_torch.scripts.train_vocab [out.npz] [--words 1024]
      [--worlds 6] [--frames 24] [--size 320x240] [--iters 10] [--device cpu]

The same arguments, steps and vocabulary file as the JAX script, plus
``--device``: the card (``cuda``) unless given, and without one it raises.
GFTT keypoints and BRIEF descriptors (``ops/gftt``, ``ops/brief``) of
rendered views of ``default_world(seed)`` along ``circle_trajectory`` for
each world seed, then k-majority k-means on the host
(``brief.train_vocabulary``) and ``brief.save_vocabulary`` (bit-packed
words with their idf weights). ``main(argv)`` returns (vocab, idf).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.device import resolve
from ..ops import brief, gftt
from ..utils import synthetic as syn


def harvest(world, traj, times, width, height, f=200.0, max_pts=96, device=None):
    """GFTT keypoints + BRIEF descriptors of rendered views at `times`:
    ([descriptors (max_pts, N_BITS)], [validity (max_pts,)]) as numpy."""
    dev = resolve(device)
    descs, valids = [], []
    for t in times:
        img = syn.render_camera_image(world, traj, float(t), width=width, height=height, f=f)
        im = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=dev)
        kp, ok = gftt.detect(im, torch.zeros((1, 2), device=dev),
                             torch.zeros(1, dtype=torch.bool, device=dev),
                             max_pts=max_pts, cell=12, border=16)
        descs.append(brief.describe(im, kp, ok).cpu().numpy())
        valids.append(ok.cpu().numpy())
    return descs, valids


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="configs/brief_vocab.npz")
    ap.add_argument("--words", type=int, default=1024)
    ap.add_argument("--worlds", type=int, default=6)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve(args.device)
    w, h = (int(x) for x in args.size.split("x"))
    all_d, all_ids = [], []
    img_id = 0
    for seed in range(args.worlds):
        world = syn.default_world(seed=seed)
        traj = syn.circle_trajectory(radius=3.0 + 0.5 * seed, period=20.0 + 2 * seed)
        times = np.linspace(0.5, 20.0, args.frames)
        descs, valids = harvest(world, traj, times, w, h, device=dev)
        for d, v in zip(descs, valids):
            all_d.append(d[v])
            all_ids.append(np.full(int(v.sum()), img_id))
            img_id += 1
        print(f"world {seed}: {sum(len(x) for x in all_d)} descriptors so far", flush=True)

    desc = np.concatenate(all_d)
    ids = np.concatenate(all_ids)
    print(f"training {args.words} words on {len(desc)} descriptors from {img_id} frames",
          flush=True)
    vocab, idf = brief.train_vocabulary(desc, n_words=args.words, iters=args.iters,
                                        image_ids=ids)
    # quantization report: word usage entropy (flat = well spread)
    a = np.argmax(desc @ vocab.T, axis=1)
    p = np.bincount(a, minlength=args.words) / len(a)
    ent = -np.sum(p[p > 0] * np.log2(p[p > 0]))
    print(f"word-usage entropy {ent:.2f} bits (max {np.log2(args.words):.2f})")
    brief.save_vocabulary(args.out, vocab, idf)
    print(f"saved {args.out}")
    return vocab, idf


if __name__ == "__main__":
    main()
