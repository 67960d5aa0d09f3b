"""`History.insert` with batches larger than the history, bitwise against
the JAX package: a batch that alone overflows the capacity evicts every
live row (the k-th live age is looked up past the table's end, which
the port clamps to its last slot and the JAX package's binary search
never indexes), over two and three inserts in a row."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.driver.history import History as JHistory

from uptune_tpu_torch.driver.history import History as THistory

from test_torch_ops import N, T, assert_bitwise

HIST_FIELDS = ("h0", "h1", "qor", "n", "age", "step", "dropped")


@pytest.mark.parametrize("cap,b,inserts", [
    (256, 432, 2),    # gcc's scale-1 step into a 256-row history
    (256, 432, 3),
    (64, 300, 3),     # k past the table by more than a whole table
])
def test_insert_larger_than_capacity(cap, b, inserts):
    hj, ht = JHistory(cap, "xla"), THistory(cap, device="cpu")
    stj, stt = hj.init(), ht.init()
    ins_j = jax.jit(hj.insert)
    rng = np.random.RandomState(cap + b + inserts)
    for _ in range(inserts):
        hashes = rng.randint(0, 2**31, (b, 2)).astype(np.uint32)
        hashes[10:20] = hashes[30:40]            # in-batch duplicates
        qor = rng.randn(b).astype(np.float32)
        valid = rng.rand(b) > 0.1
        stj = ins_j(stj, jnp.asarray(hashes), jnp.asarray(qor),
                    jnp.asarray(valid))
        stt = ht.insert(stt, T(hashes), T(qor), T(valid))
        for name, a, c in zip(HIST_FIELDS, stj, stt):
            assert_bitwise(a, N(c), name)
    assert int(stt.n) == cap
    assert int(stt.dropped) > (inserts - 1) * cap
    assert (np.diff(N(stt.h0)) >= 0).all()
    # every row the history kept is found in it
    found, _ = ht.contains(stt, torch.stack([stt.h0, stt.h1], 1))
    assert bool(found.all())
