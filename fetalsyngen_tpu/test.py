"""Integration smoke script (reference ``fetalsyngen/test.py``): instantiate
the dataset from the YAML config, generate samples, print stats, dump NIfTIs
and genparams JSON.

    python -m fetalsyngen_tpu.test --config configs/test.yaml [--bids_path ...]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default="configs/test.yaml")
    ap.add_argument("--bids_path", type=str, default=None)
    ap.add_argument("--seed_path", type=str, default=None)
    ap.add_argument("--shape", type=int, default=None,
                    help="override the generator grid edge (e.g. 64 for smoke runs)")
    ap.add_argument("--out", type=str, default="test")
    ap.add_argument("--step", type=int, default=5)
    ap.add_argument("--count", type=int, default=100)
    args = ap.parse_args()

    from fetalsyngen_tpu.compile_cache import enable_compile_cache
    from fetalsyngen_tpu.config import instantiate, load_yaml, resolve_interpolations
    from fetalsyngen_tpu.io import nifti

    enable_compile_cache()

    cfg = resolve_interpolations(load_yaml(args.config))
    cfg = cfg.get("dataset", cfg)
    if args.bids_path:
        cfg["bids_path"] = args.bids_path
    if args.seed_path:
        cfg["seed_path"] = args.seed_path
    gen_cfg = cfg.pop("generator")
    if args.shape:
        gen_cfg["shape"] = [args.shape] * 3
        gen_cfg.get("spatial_deform", {})["size"] = [args.shape] * 3
    generator = instantiate(gen_cfg)
    dataset = instantiate(cfg, generator=generator)
    print(f"dataset: {type(dataset).__name__}, len={len(dataset)}")

    os.makedirs(args.out, exist_ok=True)
    for i in range(0, args.count, args.step):
        idx = i % len(dataset)
        data = dataset[idx]
        meta = dataset.generation_params
        img, lab = data["image"], data["label"]
        print(
            f"[{i}] {data['name']}: image {img.shape} {img.dtype} "
            f"[{img.min():.4f}, {img.max():.4f}] | label {lab.shape} {lab.dtype} "
            f"max {lab.max()} | gen {meta['generation_time']:.3f}s"
        )
        nifti.save(f"{args.out}/image_{i}.nii.gz", np.asarray(img[0]))
        with open(f"{args.out}/image_{i}.json", "w") as f:
            json.dump(meta, f, indent=4, default=lambda o: np.asarray(o).tolist())


if __name__ == "__main__":
    main()
