"""Build + execute ``examples/generator.ipynb`` with real outputs embedded.

The reference ships an executed walkthrough notebook
(``examples/generator.ipynb``, SURVEY §4.4); this script authors the
equivalent for this framework — driving the in-repo real-anatomy fixture
(``data/``) through the dataset API — and executes it with nbclient so the
committed notebook carries real output images.

    python scripts/build_example_notebook.py          # ~2-4 min on CPU
"""

from __future__ import annotations

import sys
from pathlib import Path

import nbformat as nbf
from nbclient import NotebookClient

REPO = Path(__file__).resolve().parent.parent


def md(src: str):
    return nbf.v4.new_markdown_cell(src)


def code(src: str):
    return nbf.v4.new_code_cell(src)


CELLS = [
    md(
        "# FetalSynGen (JAX): generator walkthrough\n"
        "\n"
        "The JAX synthetic fetal-MRI generator, driven through the\n"
        "same three dataset configurations the reference walkthrough covers\n"
        "(`configs/dataset/{synth_train,real_train,testing}.yaml`), on the\n"
        "**real fetal subject packaged in this repo** (`data/`, see\n"
        "`data/README.md`).\n"
        "\n"
        "On a GPU host every `sample()` below runs as one fused XLA program\n"
        "on the card; the cell below pins the CPU so the walkthrough\n"
        "reproduces anywhere (same code path, same numerics contract)."
    ),
    code(
        "import jax\n"
        "# comment out on a GPU host to run on the card\n"
        'jax.config.update("jax_platforms", "cpu")\n'
        "\n"
        "import numpy as np\n"
        "import matplotlib.pyplot as plt\n"
        "from pathlib import Path\n"
        "\n"
        "from fetalsyngen_tpu.config import instantiate, load_yaml, resolve_interpolations\n"
        "\n"
        "DATA = Path('data')  # in-repo real subject + seed tree\n"
        "\n"
        "def show(vols, titles, cmap='gray'):\n"
        "    \"\"\"Axial / coronal / sagittal mid-slices for each volume.\"\"\"\n"
        "    n = len(vols)\n"
        "    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n))\n"
        "    axes = np.atleast_2d(axes)\n"
        "    for i, (v, t) in enumerate(zip(vols, titles)):\n"
        "        c = [s // 2 for s in v.shape]\n"
        "        for j, sl in enumerate((v[c[0]], v[:, c[1]], v[:, :, c[2]])):\n"
        "            axes[i, j].imshow(np.rot90(sl), cmap=cmap)\n"
        "            axes[i, j].axis('off')\n"
        "        axes[i, 0].set_title(t, loc='left', fontsize=10)\n"
        "    fig.tight_layout()\n"
        "    plt.show()"
    ),
    md(
        "## 1. Synthetic generation from real seeds (`synth_train`)\n"
        "\n"
        "`FetalSynthDataset` indexes the BIDS tree and the seed derivative\n"
        "tree, composes per-sample seeds, and generates a fully randomized\n"
        "image + label pair. One call = one fused device program\n"
        "(intensity GMM → spatial deformation → gamma → bias field →\n"
        "resample → noise)."
    ),
    code(
        "cfg = resolve_interpolations(load_yaml('configs/dataset/real_train.yaml'))\n"
        "gen_cfg = cfg.pop('generator')\n"
        "for k in ('blur_cortex', 'struct_noise', 'simulate_motion', 'boundaries'):\n"
        "    gen_cfg.pop(k, None)  # SR artifacts covered in docs/sr_artif_api.md\n"
        "cfg.update(bids_path=str(DATA), seed_path=str(DATA / 'derivatives' / 'seeds'),\n"
        "           image_as_intensity=False)\n"
        "ds = instantiate(cfg, generator=instantiate(gen_cfg))\n"
        "print(f'{len(ds)} subject(s):', ds._sub_ses_idx(0))\n"
        "\n"
        "item = ds.sample_with_meta(0)\n"
        "img, lab = np.asarray(item['image'][0]), np.asarray(item['label'][0])\n"
        "print('image', img.shape, f'[{img.min():.2f}, {img.max():.2f}]',\n"
        "      ' labels:', len(np.unique(lab)))\n"
        "show([img], ['synthetic sample (from sub-sta21 seeds)'])\n"
        "show([lab.astype(float)], ['label map'], cmap='nipy_spectral')"
    ),
    md(
        "## 2. Fixed (replayed) generation\n"
        "\n"
        "Every sample returns its `generation_params`; passing the dict back\n"
        "reproduces the volume **voxel-exactly** (the PRNG key is embedded,\n"
        "so even the noise field replays — the reference contract from\n"
        'docs "Fixed Image Generation", extended to bit-exactness).'
    ),
    code(
        "replay = ds.sample_with_meta(0, genparams=item['generation_params'])\n"
        "print('voxel-identical:', np.array_equal(np.asarray(replay['image']), np.asarray(item['image'])))\n"
        "\n"
        "# pin only some scalars (everything else re-randomizes)\n"
        "pinned = ds.sample_with_meta(0, genparams={\n"
        "    'resample_params': {'spacing': [1.5, 1.5, 1.5]},\n"
        "})\n"
        "print('pinned spacing ->', pinned['generation_params']['resample_params']['spacing'])"
    ),
    md(
        "## 3. Image-as-intensity augmentation (`real_train`)\n"
        "\n"
        "With `image_as_intensity: true` the subject's own T2w drives the\n"
        "intensities and the pipeline becomes an augmentor (deformation +\n"
        "gamma + bias + resample + noise) — the reference's real-data\n"
        "training mode."
    ),
    code(
        "cfg2 = resolve_interpolations(load_yaml('configs/dataset/real_train.yaml'))\n"
        "gen_cfg2 = cfg2.pop('generator')\n"
        "for k in ('blur_cortex', 'struct_noise', 'simulate_motion', 'boundaries'):\n"
        "    gen_cfg2.pop(k, None)\n"
        "cfg2.update(bids_path=str(DATA), seed_path=None)\n"
        "ds_real = instantiate(cfg2, generator=instantiate(gen_cfg2))\n"
        "aug = ds_real[0]\n"
        "show([np.asarray(aug['image'][0])], ['augmented real T2w'])"
    ),
    md(
        "## 4. Offline test loading with invertible transforms (`testing`)\n"
        "\n"
        "`FetalTestDataset` applies the deterministic eval transform chain\n"
        "(orientation, crop-foreground, spacing, pad/crop, scale); every\n"
        "transform is invertible via `reverse_transform` so predictions map\n"
        "back to native space."
    ),
    code(
        "cfg3 = resolve_interpolations(load_yaml('configs/dataset/testing.yaml'))\n"
        "cfg3['bids_path'] = str(DATA)\n"
        "tf = instantiate(cfg3.pop('transforms'))\n"
        "ds_test = instantiate(cfg3, transforms=tf)\n"
        "t_item = ds_test[0]\n"
        "rev = ds_test.reverse_transform(dict(t_item))\n"
        "print('transformed', t_item['image'].shape, '-> reversed', rev['image'].shape)\n"
        "show([np.asarray(t_item['image'][0])], ['eval-transformed T2w'])"
    ),
    md(
        "## Going further\n"
        "\n"
        "- **Production throughput**: `fetalsyngen_tpu.parallel.SyntheticStream`\n"
        "  — device-resident seed banks, one fused batch program, prefetch;\n"
        "  throughput on the GPU: see `PERF.md`.\n"
        "- **SR artifacts** (blur-cortex, structural noise, motion + PSF\n"
        "  reconstruction, boundaries): `docs/sr_artif_api.md`; the stream\n"
        "  applies them in-program, and `SyntheticStream(genparams=...)` pins\n"
        "  `resolution_slice` / `slice_thickness` / `gap` and artifact gates.\n"
        "- **Multi-GPU**: `fetalsyngen_tpu.parallel.sharding` shards the\n"
        "  generator over a `jax.sharding.Mesh` (`docs/design.md`).\n"
        "- Training example: `examples/train_segmentation.py`."
    ),
]


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = CELLS
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3",
    }
    client = NotebookClient(nb, timeout=1200, kernel_name="python3",
                            resources={"metadata": {"path": str(REPO)}})
    client.execute()
    out = REPO / "examples" / "generator.ipynb"
    nbf.write(nb, str(out))
    n_img = sum(
        1
        for c in nb.cells
        for o in c.get("outputs", [])
        if "image/png" in o.get("data", {})
    )
    print(f"wrote {out} ({n_img} embedded figures)")
    if n_img < 4:
        sys.exit("expected >= 4 figures in the executed notebook")


if __name__ == "__main__":
    main()
