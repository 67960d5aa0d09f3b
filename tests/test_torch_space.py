"""Parity of the port's Space (codecs, hashing, signature) with the JAX
package on the flagship's mixed space at 4096 rows.

Tolerances: the f64 host codecs, the signature and every lane whose
decode involves no transcendental are bitwise equal.  LOG_FLOAT lanes
(expm1) match to rtol 3e-5, the accuracy of XLA's f32 transcendentals.
A LOG_INT lane rounds an expm1 result, so a value within a few ulps of a
.5 boundary may round the other way on the two sides and hash
differently: canonical lanes and hashes are compared bitwise on rows away
from such boundaries, and at least 99.9% of all rows must agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.space import params as JP
from uptune_tpu.space.spec import Space as JSpace
from uptune_tpu.space.spec import pad_cands as jpad

from uptune_tpu_torch import rng as trng
from uptune_tpu_torch.space import params as TP
from uptune_tpu_torch.space.spec import Space as TSpace
from uptune_tpu_torch.space.spec import concat_cands, pad_cands

from test_torch_ops import (N, T, _flagship_specs, assert_bitwise,
                            assert_cands_equal, jcands_to_t)

ROWS = 4096


def _specs(P):
    # the flagship space plus one LOG_FLOAT lane, so every codec kind runs
    return _flagship_specs(P) + [P.LogFloatParam("lf0", 0.5, 300.0)]


@pytest.fixture(scope="module")
def setup():
    space_j, space_t = JSpace(_specs(JP)), TSpace(_specs(TP))
    cands_j = space_j.random(jax.random.PRNGKey(0), ROWS)
    return space_j, space_t, cands_j, jcands_to_t(cands_j)


def _kind(space_j):
    return np.asarray(space_j.kind)


def _near_half(space_j, u):
    """[rows] bool: a LOG_INT lane's f64 pre-round value lies within
    1e-5 (relative) of a .5 rounding boundary."""
    kind = _kind(space_j)
    m = kind == JP.LOG_INT
    slo = np.asarray(space_j.slo, np.float64)[m]
    shi = np.asarray(space_j.shi, np.float64)[m]
    vlo = np.asarray(space_j.vlo, np.float64)[m]
    s = u[:, m].astype(np.float64) * (shi - slo) + slo
    v = np.expm1(s * np.log(2.0)) + vlo
    frac = v - np.floor(v)
    return (np.abs(frac - 0.5) < 1e-5 * np.maximum(1.0, np.abs(v))).any(1)


def test_signature_and_tables(setup):
    space_j, space_t, _, _ = setup
    assert space_t.signature() == space_j.signature()
    assert space_t.perm_sizes == space_j.perm_sizes
    assert space_t.n_scalar == space_j.n_scalar
    t = space_t.tables(torch.device("cpu"))
    for name in ("kind", "slo", "shi", "vlo", "vhi", "int_mask",
                 "complex_mask"):
        assert_bitwise(getattr(space_j, name), N(getattr(t, name)), name)
    mults = np.asarray(space_j._hash_mults).astype(np.int64)
    assert_bitwise(mults, N(t.hash_lo) + (N(t.hash_hi) << 16), "mults")


def test_params_module_is_a_copy():
    import inspect
    import uptune_tpu.space.params as jp
    import uptune_tpu_torch.space.params as tp
    assert inspect.getsource(jp) == inspect.getsource(tp)


def test_host_codecs_bitwise(setup):
    space_j, space_t, cands_j, cands_t = setup
    u = np.asarray(cands_j.u)
    vals_j = space_j.decode_scalars_np(u)
    vals_t = space_t.decode_scalars_np(N(cands_t.u))
    assert np.array_equal(vals_j, vals_t)
    assert np.array_equal(space_j.encode_scalars_np(vals_j),
                          space_t.encode_scalars_np(vals_t))
    cfgs_j = space_j.to_configs(cands_j[:256])
    cfgs_t = space_t.to_configs(cands_t[:256])
    assert cfgs_j == cfgs_t
    back_j = space_j.from_configs(cfgs_j)
    back_t = space_t.from_configs(cfgs_t, device="cpu")
    assert_cands_equal(back_j, back_t, "from_configs")


def test_device_decode(setup):
    space_j, space_t, cands_j, cands_t = setup
    dec_j = np.asarray(space_j.decode_scalars(cands_j.u))
    dec_t = N(space_t.decode_scalars(cands_t.u))
    kind = _kind(space_j)
    exact = np.isin(kind, [JP.FLOAT, JP.INT, JP.POW2, JP.BOOL, JP.ENUM])
    assert_bitwise(dec_j[:, exact], dec_t[:, exact], "exact lanes")
    lf = kind == JP.LOG_FLOAT
    np.testing.assert_allclose(dec_t[:, lf], dec_j[:, lf], rtol=3e-5)
    li = kind == JP.LOG_INT
    away = ~_near_half(space_j, np.asarray(cands_j.u))
    assert_bitwise(dec_j[away][:, li], dec_t[away][:, li], "log_int")


def test_device_encode(setup):
    space_j, space_t, cands_j, cands_t = setup
    vals = space_j.decode_scalars_np(np.asarray(cands_j.u)).astype(
        np.float32)
    enc_j = np.asarray(space_j.encode_scalars(jnp.asarray(vals)))
    enc_t = N(space_t.encode_scalars(T(vals)))
    np.testing.assert_allclose(enc_t, enc_j, rtol=3e-5, atol=1e-6)


def test_canonical_lanes_and_hashes(setup):
    space_j, space_t, cands_j, cands_t = setup
    lanes_j = np.asarray(space_j.canonical_lanes(cands_j))
    lanes_t = N(space_t.canonical_lanes(cands_t))
    h_j = np.asarray(space_j.hash_batch(cands_j)).astype(np.int64)
    h_t = N(space_t.hash_batch(cands_t))
    away = ~_near_half(space_j, np.asarray(cands_j.u))
    assert away.mean() > 0.99
    assert_bitwise(lanes_j[away], lanes_t[away], "lanes")
    assert_bitwise(h_j[away], h_t[away], "hashes")
    same = (h_j == h_t).all(1)
    assert same.mean() >= 0.999
    assert ((h_t >= 0) & (h_t <= 0xFFFFFFFF)).all()


def test_features_seed_default_pad(setup):
    space_j, space_t, cands_j, cands_t = setup
    assert_bitwise(space_j.features(cands_j), N(space_t.features(cands_t)),
                   "features")
    assert_cands_equal(space_j.seed_default(5),
                       space_t.seed_default(5, device="cpu"), "seed")
    assert_cands_equal(jpad(cands_j[:3], 8), pad_cands(cands_t[:3], 8),
                       "pad")
    both = concat_cands([cands_t[:2], cands_t[5:7]])
    assert both.batch == 4
    with pytest.raises(TypeError):
        cands_t[0]


def test_concat_matches_concat_cands_and_jax(setup):
    """`CandBatch.concat` (the surrogate pool joins its random and local
    rows with it) equals `concat_cands` and the JAX method on converted
    inputs, bitwise."""
    _, _, cands_j, cands_t = setup
    a_t, b_t = cands_t[:3], cands_t[7:12]
    got = a_t.concat(b_t)
    assert got.batch == 8
    assert_cands_equal(cands_j[:3].concat(cands_j[7:12]), got, "concat")
    ref = concat_cands([a_t, b_t])
    assert torch.equal(got.u, ref.u)
    assert all(torch.equal(p, q) for p, q in zip(got.perms, ref.perms))
    assert all(p.dtype == torch.int64 for p in got.perms)


def test_random_is_valid():
    space_t = TSpace(_specs(TP))
    gen = trng.generator(3, "cpu")
    c = space_t.random(gen, 512)
    u = N(c.u)
    assert u.shape == (512, space_t.n_scalar)
    assert (u >= 0).all() and (u < 1).all()
    assert all(sorted(r) == list(range(12)) for r in N(c.perms[0]))


def test_cuda_default_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CUDA default is accepted")
    space_t = TSpace(_specs(TP))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        space_t.seed_default(2)
