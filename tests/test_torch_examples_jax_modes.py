"""The port's three- and four-mode box example scripts against the JAX
library, on the CPU in FAST mode, f64 (the method, and the bounds of the
mode below the others' round-off: tests/test_torch_examples_jax.py)."""

import pytest
import torch

from test_torch_examples_jax import check_example_against_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["box_gamma_mixture_3modes", "box_gamma_mixture_4modes"])
def test_example_matches_jax(name, tmp_path, monkeypatch):
    check_example_against_jax(name, tmp_path, monkeypatch)
