"""Per-tier cost attribution through ONE compiled stream program.

Uses the stream's genparams pinning (``SyntheticStream(genparams=...)``) to
route EVERY sample of a batch to one engine variant — motion off / small
px-frame / each static tier — while executing the same batch program: pins
are host-side draw overrides, the trace is unchanged, so each variant after
the first costs no compile. Differences between variants are the per-tier
motion-engine costs in the production program.

Prints the card (name and power limit from ``nvidia-smi``) and one JSON line
per variant; fails without a GPU.

Usage: python scripts/profile_pinned_tiers.py [--iters 6] [--batch 4]
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from fetalsyngen_tpu.compile_cache import enable_compile_cache

REPO = Path(__file__).resolve().parent.parent


def build_ds(shape):
    from fetalsyngen_tpu.config import instantiate, load_yaml, resolve_interpolations
    from fetalsyngen_tpu.data.datasets import FetalSynthDataset
    from fetalsyngen_tpu.io import nifti
    from fetalsyngen_tpu.testing import phantom_seeds_and_seg

    root = Path(tempfile.mkdtemp(prefix="fsg_pintier_"))
    for si, sub in enumerate(["sub-b01", "sub-b02"]):
        seeds_np, seg_np = phantom_seeds_and_seg(shape, seed=si)
        anat = root / sub / "anat"
        anat.mkdir(parents=True)
        nifti.save(anat / f"{sub}_dseg.nii.gz", seg_np.astype(np.int16))
        nifti.save(anat / f"{sub}_T2w.nii.gz", (seg_np > 0).astype(np.float32))
        for n in (1, 2):
            sd = root / "derivatives" / "seeds" / f"subclasses_{n}" / sub / "anat"
            sd.mkdir(parents=True)
            for m in range(1, 5):
                part = np.where(seeds_np % 4 == (m - 1), seeds_np, 0).astype(np.int8)
                nifti.save(sd / f"{sub}_mlabel_{m}.nii.gz", part)
    gen_cfg = resolve_interpolations(
        load_yaml(REPO / "configs" / "dataset" / "generator" / "default.yaml")
    )
    gen_cfg["shape"] = list(shape)
    gen_cfg["spatial_deform"]["size"] = list(shape)
    generator = instantiate(gen_cfg)
    return FetalSynthDataset(str(root), generator, str(root / "derivatives" / "seeds"))


# pins routing every sample to one engine variant (gap pinned where the
# small-frame eligibility needs gap_px > 2)
VARIANTS = {
    "default_mix": None,
    "motion_off": {"apply": False},
    "small256": {"resolution_slice": 0.75, "gap": 2.5},
    "tier384": {"resolution_slice": 0.45},
    "tier512": {"resolution_slice": 0.35},
    "tier640": {"resolution_slice": 0.26},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()

    from fetalsyngen_tpu.accelerator import device_record, nvidia_smi_cards, require_gpu
    from fetalsyngen_tpu.parallel.input_pipeline import SyntheticStream

    devices = require_gpu(jax.devices())
    for line in nvidia_smi_cards():
        print(line, flush=True)
    device = device_record(devices)
    enable_compile_cache()

    ds = build_ds((256, 256, 256))
    results = {}
    batch_fn = None
    for name, pin in VARIANTS.items():
        gp = None if pin is None else {"artifact_params": {"simulate_motion": pin}}
        stream = SyntheticStream(
            ds, batch_size=args.batch, seed=0, prefetch=False, genparams=gp
        )
        if batch_fn is not None:
            stream._batch_fn = batch_fn  # same program: pins are host-side
        it = iter(stream)
        for _ in range(2):
            b = next(it)
            jax.block_until_ready(b["image"])
        batch_fn = stream._batch_fn
        if pin and "resolution_slice" in pin:
            rec = b["meta"]["scanner"]
            assert np.allclose(
                rec["resolution_slice"], pin["resolution_slice"]
            ), rec["resolution_slice"]
        t0 = time.perf_counter()
        for _ in range(args.iters):
            jax.block_until_ready(next(it)["image"])
        per_batch = (time.perf_counter() - t0) / args.iters
        results[name] = per_batch
        print(
            json.dumps(
                {
                    "device": device,
                    "variant": name,
                    "s_per_batch": per_batch,
                    "vol_per_s": args.batch / per_batch,
                }
            ),
            flush=True,
        )
    base = results["motion_off"]
    for name, t in results.items():
        if name != "motion_off":
            print(
                json.dumps(
                    {"variant": name + "-motion_cost", "s_per_batch_motion_only": t - base}
                ),
                flush=True,
            )


if __name__ == "__main__":
    main()
