"""Packaging smoke: build wheel -> `pip install` (no extras) -> generate.

The core package must import and generate WITHOUT flax or PyYAML. This
builds the real wheel, installs it with ``--no-deps`` into an isolated
``--target`` site (core deps come from the running interpreter so no network
is needed), poisons ``flax``, ``optax`` and ``yaml`` in ``sys.modules``, and
runs a tiny end-to-end generation through the public API from a directory
OUTSIDE the repo — asserting the package actually resolves from the
installed wheel, not the checkout.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SMOKE = textwrap.dedent(
    """
    import sys

    # the core package needs neither flax nor the optax train extra, and
    # reads its YAML configs without PyYAML
    sys.modules["flax"] = None
    sys.modules["optax"] = None
    sys.modules["yaml"] = None

    import os
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import fetalsyngen_tpu

    site = os.environ["SMOKE_SITE"]
    assert fetalsyngen_tpu.__file__.startswith(site), fetalsyngen_tpu.__file__
    assert fetalsyngen_tpu.__version__
    assert fetalsyngen_tpu.parse_yaml("a: [1, 2]  # c") == {"a": [1, 2]}

    # packaged data: the recorded motion trajectories must resolve
    from fetalsyngen_tpu.generator.artifacts import motion

    # end-to-end: mini-BIDS tree -> dataset -> sample -> replay
    import tempfile
    from pathlib import Path

    from fetalsyngen_tpu.data.datasets import FetalSynthDataset
    from fetalsyngen_tpu.generator.model import (
        FetalSynthGen, ImageFromSeeds, RandBiasField, RandGamma, RandNoise,
        RandResample, SpatialDeformation,
    )
    from fetalsyngen_tpu.testing import build_bids_tree

    shape = (32, 32, 32)
    root = Path(tempfile.mkdtemp()) / "bids"
    root.mkdir(parents=True)
    build_bids_tree(root, shape=shape)

    labels = tuple(range(50))
    gen = FetalSynthGen(
        shape=shape, resolution=(0.5, 0.5, 0.5),
        intensity_generator=ImageFromSeeds(1, 2, labels, labels),
        spatial_deform=SpatialDeformation(20, 0.02, 0.1, shape, 0.9, True, 0.03, 0.06, 4.0, 0.5),
        resampler=RandResample(0.9, 0.5, 1.5),
        bias_field=RandBiasField(0.9, 0.01, 0.06, 0.01, 0.3),
        noise=RandNoise(0.9, 5, 15), gamma=RandGamma(0.9, 0.1), seed=0,
    )
    ds = FetalSynthDataset(str(root), gen, str(root / "derivatives" / "seeds"))
    data, params = ds.sample(0)
    img = data["image"]
    assert img.shape == (1, *shape) and np.isfinite(img).all()
    assert 0.0 <= img.min() and img.max() <= 1.0
    data2, _ = ds.sample(0, genparams=params)
    np.testing.assert_array_equal(data["image"], data2["image"])
    print("PACKAGING-SMOKE-OK")
    """
)


@pytest.mark.slow
def test_wheel_install_import_generate(tmp_path):
    import os

    wheels = tmp_path / "wheels"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "-q", "--no-deps",
         "--no-build-isolation", "-w", str(wheels), str(REPO)],
        capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    whl = list(wheels.glob("fetalsyngen_tpu-*.whl"))
    assert len(whl) == 1, whl

    site = tmp_path / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "-q", "--no-deps",
         "--target", str(site), str(whl[0])],
        capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    # package data shipped in the wheel
    assert (site / "fetalsyngen_tpu" / "generator" / "artifacts" / "motion_traj.npz").exists()

    script = tmp_path / "smoke.py"
    script.write_text(SMOKE)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SMOKE_SITE"] = str(site)
    # the installed site shadows the checkout (PYTHONPATH precedes .pth
    # entries)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(site), env.get("PYTHONPATH")]))
    # run OUTSIDE the repo so imports resolve from the installed wheel only
    r = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        cwd=str(tmp_path), env=env, timeout=900,
    )
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-3000:])
    assert "PACKAGING-SMOKE-OK" in r.stdout
