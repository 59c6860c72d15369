"""Dataset API: BIDS discovery + on-the-fly synthesis.

Reference-parity layer over ``fetalsyngen/data/datasets.py``:

- :class:`FetalDataset` — BIDS tree walking (``datasets.py:17-103``);
- :class:`FetalTestDataset` — offline real-data loading with transforms
  (``datasets.py:106-186``);
- :class:`FetalSynthDataset` — on-the-fly synthetic generation
  (``datasets.py:189-370``) with ``sample``/``sample_with_meta``/``__getitem__``
  and the genparams replay contract.

Samples are plain numpy/dict structures (framework-agnostic): ``image`` is a
(1, D, H, W) float32 in [0, 1], ``label`` a (1, D, H, W) int array, ``name`` a
string — drop-in for any trainer, including a torch ``DataLoader`` with the
default collate. For training on an accelerator prefer
:mod:`fetalsyngen_tpu.parallel.input_pipeline`, which batches generation on
device instead of forking host workers.
"""

from __future__ import annotations

import time
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..generator.model import FetalSynthGen
from ..io import nifti
from .transforms import Compose, scale_intensity


class FetalDataset:
    """Abstract dataset: BIDS subject/session discovery."""

    def __init__(self, bids_path: str, sub_list: list[str] | None):
        self.bids_path = Path(bids_path)
        self.subjects = self.find_subjects(sub_list)
        if self.subjects is None:
            self.subjects = sorted(x.name for x in self.bids_path.glob("sub-*"))
        self.sub_ses = [
            (x, y) for x in self.subjects for y in self._get_ses(self.bids_path, x)
        ]
        self.img_paths = self._load_bids_path(self.bids_path, "T2w")
        self.segm_paths = self._load_bids_path(self.bids_path, "dseg")

    def find_subjects(self, sub_list):
        """Restrict discovery to ``sub_list`` (None = keep every ``sub-*``)."""
        if sub_list is None:
            return None
        present = {p.name for p in self.bids_path.glob("sub-*")}
        return sorted(present.intersection(sub_list))

    def _sub_ses_string(self, sub, ses):
        return f"{sub}_{ses}" if ses is not None else sub

    def _sub_ses_idx(self, idx):
        sub, ses = self.sub_ses[idx]
        return self._sub_ses_string(sub, ses)

    def _get_ses(self, bids_path, sub):
        """Session ids for one subject.

        A session-less subject keeps ``anat/`` directly under its directory
        and is represented by a single ``None`` entry; any other child
        directory is treated as a session id (reference behavior).
        """
        sessions = [
            None if "anat" in child.name else child.name
            for child in (bids_path / sub).iterdir()
            if child.is_dir()
        ]
        return sorted(sessions, key=lambda s: s or "")

    def _get_pattern(self, sub, ses, suffix, extension=".nii.gz"):
        """BIDS glob for one subject(/session) anat file with ``suffix``."""
        if ses is None:
            return f"{sub}/anat/{sub}*_{suffix}{extension}"
        return f"{sub}/{ses}/anat/{sub}_{ses}*_{suffix}{extension}"

    def _load_bids_path(self, path, suffix):
        """One file per (sub, ses), in ``self.sub_ses`` order.

        Raises ``FileNotFoundError`` on a missing file and ``RuntimeError``
        on an ambiguous (multi-match) pattern, like the reference API.
        """

        def one(sub, ses):
            pattern = self._get_pattern(sub, ses, suffix)
            matches = sorted(path.glob(pattern))
            if not matches:
                raise FileNotFoundError(
                    f"{path}: pattern '{pattern}' matched no file for {sub}"
                )
            if len(matches) > 1:
                raise RuntimeError(
                    f"{path}: pattern '{pattern}' is ambiguous for {sub}: {matches}"
                )
            return matches[0]

        return [one(sub, ses) for sub, ses in self.sub_ses]

    def __len__(self):
        return len(self.subjects)

    def __getitem__(self, idx):
        raise NotImplementedError("This method should be implemented in the child class.")


class FetalTestDataset(FetalDataset):
    """Offline test/validation dataset (reference ``datasets.py:106-186``)."""

    def __init__(
        self,
        bids_path: str,
        sub_list: list[str] | None = None,
        transforms: Compose | None = None,
    ):
        super().__init__(bids_path, sub_list)
        self.transforms = transforms

    def _load_data(self, idx):
        image = nifti.load(self.img_paths[idx])
        segm = nifti.load(self.segm_paths[idx])
        name = self.sub_ses[idx]
        name = self._sub_ses_string(name[0], ses=name[1])
        img = image.data[None].astype(np.float32)
        seg = segm.data[None]
        if img.ndim != 4:
            raise ValueError(f"Expected 3D image, got shape {image.data.shape}")
        return {
            "image": img,
            "label": seg.astype(np.int64),
            "name": name,
            "image_affine": image.affine,
            "label_affine": segm.affine,
        }

    def __getitem__(self, idx) -> dict:
        data = self._load_data(idx)
        if self.transforms:
            data = self.transforms(data)
        data["label"] = np.asarray(data["label"]).astype(np.int64)
        return data

    def reverse_transform(self, data: dict) -> dict:
        if self.transforms:
            data = self.transforms.inverse(data)
        return data


class FetalSynthDataset(FetalDataset):
    """On-the-fly synthetic dataset (reference ``datasets.py:189-370``)."""

    def __init__(
        self,
        bids_path: str,
        generator: FetalSynthGen,
        seed_path: str | None = None,
        sub_list: list[str] | None = None,
        load_image: bool = False,
        image_as_intensity: bool = False,
    ):
        super().__init__(bids_path, sub_list)
        self.seed_path = Path(seed_path) if isinstance(seed_path, str) else None
        self.load_image = load_image
        self.generator = generator
        self.image_as_intensity = image_as_intensity

        if not self.image_as_intensity and isinstance(self.seed_path, Path):
            if not self.seed_path.exists():
                raise FileNotFoundError(f"Provided seed path {self.seed_path} does not exist.")
            self._load_seed_path()

    def _load_seed_path(self):
        """Index the seed derivative tree (reference ``datasets.py:232-254``)."""
        self.seed_paths = {
            self._sub_ses_string(sub, ses): defaultdict(dict) for (sub, ses) in self.sub_ses
        }
        avail = [
            int(x.name.replace("subclasses_", ""))
            for x in self.seed_path.glob("subclasses_*")
        ]
        if not avail:
            raise FileNotFoundError(f"No subclasses_* dirs under {self.seed_path}")
        for n_sub in range(min(avail), max(avail) + 1):
            seed_dir = self.seed_path / f"subclasses_{n_sub}"
            if not seed_dir.exists():
                raise FileNotFoundError(f"Provided seed path {seed_dir} does not exist.")
            for i in range(1, 5):
                files = self._load_bids_path(seed_dir, f"mlabel_{i}")
                for (sub, ses), file in zip(self.sub_ses, files):
                    self.seed_paths[self._sub_ses_string(sub, ses)][n_sub][i] = file

    def sample(self, idx, genparams: dict | None = None) -> tuple[dict, dict]:
        """Generate one sample; returns (data dict, generation params).

        Matches reference ``datasets.py:256-327``: image scaled to [0, 1],
        RAS orientation, genparams dict replays the sample exactly (ours also
        replays voxel noise via the embedded PRNG key).
        """
        genparams = dict(genparams or {})
        generation_params: dict = {}

        image = nifti.load_ras(self.img_paths[idx]).data if self.load_image else None
        segm = nifti.load_ras(self.segm_paths[idx]).data

        name = self.sub_ses[idx]
        name = self._sub_ses_string(name[0], ses=name[1])

        seeds = None
        if self.seed_path is not None:
            seeds = self.seed_paths[name]
        if self.image_as_intensity:
            seeds = None

        generation_params["idx"] = idx
        generation_params["img_paths"] = str(self.img_paths[idx])
        generation_params["segm_paths"] = str(self.segm_paths[idx])
        generation_params["seeds"] = str(self.seed_path)
        t0 = time.time()

        gen_output, segmentation, image, synth_params = self.generator.sample(
            image=image, segmentation=segm, seeds=seeds, genparams=genparams
        )

        gen_output = scale_intensity(np.asarray(gen_output), 0.0, 1.0)
        image = scale_intensity(np.asarray(image), 0.0, 1.0) if image is not None else None
        segmentation = np.asarray(segmentation)

        generation_params = {**generation_params, **synth_params}
        generation_params["generation_time"] = time.time() - t0
        data_out = {
            "image": gen_output[None].astype(np.float32),
            "label": segmentation[None].astype(np.int64),
            "name": name,
        }
        return data_out, generation_params

    def __getitem__(self, idx) -> dict:
        data_out, generation_params = self.sample(idx)
        self.generation_params = generation_params
        return data_out

    def sample_with_meta(self, idx: int, genparams: dict | None = None) -> dict:
        data, generation_params = self.sample(idx, genparams=genparams)
        data["generation_params"] = generation_params
        return data
