"""The port's fixed-step integrator (`cloudy_tpu_torch.stepper`) against the
JAX package's: the time an RHS sees.

JAX carries `t` in its scan in the state's dtype (cloudy_tpu/stepper.py:
178), so an f32 run adds dt = 0.1 in f32 and the stages see t, t + dt and
t + dt/2 rounded to f32 each step. The port carries it the same way; the
sequence an RHS reads over 1000 f32 steps is JAX's, bit for bit.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from cloudy_tpu import stepper as jstepper

from cloudy_tpu_torch import stepper

torch.set_num_threads(1)

N_STEPS, DT = 1000, 0.1


def test_integrate_t_sequence_matches_jax():
    jseen = []

    def jf(y, t):
        jax.debug.callback(lambda tt: jseen.append(np.asarray(tt)), t, ordered=True)
        return -0.01 * y

    _, jys = jstepper.integrate(jf, jnp.ones(3, jnp.float32), 0.0, DT, N_STEPS, save_every=100)
    jax.block_until_ready(jys)
    seen = []

    def f(y, t):
        seen.append(t)
        return -0.01 * y

    _, ys = stepper.integrate(f, torch.ones(3, dtype=torch.float32), 0.0, DT, N_STEPS,
                              save_every=100)
    assert len(seen) == len(jseen) == 3 * N_STEPS
    assert all(torch.is_tensor(t) and t.dtype == torch.float32 for t in seen)
    want = np.asarray(jseen, np.float32)
    got = np.asarray([t.item() for t in seen], np.float32)
    np.testing.assert_array_equal(got, want)
    # the f32 sum has drifted from the exact times, as JAX's has
    assert got[3 * (N_STEPS - 1)] != np.float32((N_STEPS - 1) * DT)
    # the trajectories: f32 rounding of 1000 steps, XLA's fusion against torch's ops
    assert ys.dtype == torch.float32 and ys.shape == (11, 3)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-5)
