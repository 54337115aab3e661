"""The port's four-mode box with moving thresholds
(`box_gamma_mix_moving`) against the JAX library, on the CPU in FAST mode,
f64, rtol 1e-10 over the trajectory (the method:
tests/test_torch_examples_jax.py). A file of its own: the port's run and
JAX's compile take ~20 s each."""

import torch

from test_torch_examples_jax import check_example_against_jax

torch.set_num_threads(1)


def test_example_matches_jax(tmp_path, monkeypatch):
    check_example_against_jax("box_gamma_mix_moving", tmp_path, monkeypatch)
