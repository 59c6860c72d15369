"""fetalsyngen-tpu: synthetic fetal-brain-MRI data generator in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
Medical-Image-Analysis-Laboratory/fetalsyngen. See README.md and PARITY.md.
"""

from .config import (
    instantiate,
    load_and_instantiate,
    load_yaml,
    parse_yaml,
    resolve_interpolations,
)

__all__ = [
    "instantiate",
    "load_and_instantiate",
    "load_yaml",
    "parse_yaml",
    "resolve_interpolations",
]

__version__ = "1.0.0"
