"""Walkthrough: the three dataset configurations (reference
``examples/generator.ipynb`` equivalent, as a runnable script).

Builds a tiny procedural BIDS tree, then exercises:
1. synthetic generation from seeds (synth_train),
2. image-as-intensity augmentation (real_train),
3. offline test loading with invertible transforms (testing),
and demonstrates genparams replay. Writes NIfTIs under ``example_out/``.

    python examples/generator.py [--shape 64]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# allow running from a repo checkout without installing; an installed
# package needs no path tweaks (all imports below are packaged)
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, default=64)
    ap.add_argument("--out", type=str, default="example_out")
    args = ap.parse_args()

    import numpy as np

    from fetalsyngen_tpu.compile_cache import enable_compile_cache
    from fetalsyngen_tpu.config import instantiate, load_yaml, resolve_interpolations
    from fetalsyngen_tpu.io import nifti
    from fetalsyngen_tpu.testing import build_bids_tree

    enable_compile_cache()

    root = Path(args.out) / "bids"
    root.mkdir(parents=True, exist_ok=True)
    if not (root / "sub-aaa").exists():
        build_bids_tree(root, shape=(args.shape,) * 3)
    out_dir = Path(args.out)

    def dataset_from(config_path, **overrides):
        cfg = resolve_interpolations(load_yaml(config_path))
        cfg["bids_path"] = str(root)
        if cfg.get("seed_path"):
            cfg["seed_path"] = str(root / "derivatives" / "seeds")
        gen_cfg = cfg.pop("generator", None)
        cfg.update(overrides)
        if gen_cfg is not None:
            s = [args.shape] * 3
            gen_cfg["shape"] = s
            gen_cfg["spatial_deform"]["size"] = s
            gen_cfg["intensity_generator"]["max_subclusters"] = 2
            for k in ("blur_cortex", "struct_noise", "simulate_motion", "boundaries"):
                gen_cfg.pop(k, None)  # keep the walkthrough fast
            return instantiate(cfg, generator=instantiate(gen_cfg))
        transforms = cfg.pop("transforms", None)
        return instantiate(cfg, transforms=instantiate(transforms) if transforms else None)

    # 1. synthetic generation from seeds
    ds = dataset_from("configs/dataset/synth_train.yaml")
    item = ds.sample_with_meta(0)
    print("[synth_train]", item["name"], item["image"].shape, "gen",
          f"{item['generation_params']['generation_time']:.2f}s")
    nifti.save(out_dir / "synth_image.nii.gz", item["image"][0])
    nifti.save(out_dir / "synth_label.nii.gz", item["label"][0].astype(np.int16))

    # genparams replay: identical volume
    replay = ds.sample_with_meta(0, genparams=item["generation_params"])
    assert np.allclose(replay["image"], item["image"], atol=1e-5)
    print("[replay] voxel-identical: True")

    # 2. image-as-intensity (real_train)
    ds_real = dataset_from("configs/dataset/real_train.yaml")
    item2 = ds_real[0]
    print("[real_train]", item2["name"], item2["image"].shape)
    nifti.save(out_dir / "real_aug_image.nii.gz", item2["image"][0])

    # 3. offline test data with invertible transforms
    cfg = resolve_interpolations(load_yaml("configs/dataset/testing.yaml"))
    cfg["bids_path"] = str(root)
    tf = instantiate(cfg.pop("transforms"))
    for t in tf.transforms:
        if hasattr(t, "spatial_size"):
            t.spatial_size = (args.shape,) * 3
        if hasattr(t, "roi_size"):
            t.roi_size = (args.shape,) * 3
    ds_test = instantiate(cfg, transforms=tf)
    item3 = ds_test[0]
    rev = ds_test.reverse_transform(dict(item3))
    print("[testing]", item3["image"].shape, "-> reversed", rev["image"].shape)
    print(f"done; outputs in {out_dir}/")


if __name__ == "__main__":
    main()
