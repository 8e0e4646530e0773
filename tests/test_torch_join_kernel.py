"""The port's MERGE join (``delta_tpu_torch.ops.join_kernel``) against
``delta_tpu.ops.join_kernel`` on the CPU: ``inner_join`` (the upload route,
K12 through its plain version), ``_host_join`` and ``_sentinel_encode`` on
``tests/test_link.py``'s inputs (those without a ``budget_s``), the plain
K12 against JAX's ``_single_device_kernel`` on the same padded int32 and
int64 inputs (among them the traffics the card's hash table is held to:
a duplicate-heavy source, all-miss and all-hit targets, the types' extreme
keys), and the host equi join against a brute-force pairing.
Every comparison is exact."""
import jax
import numpy as np
import pytest
import torch

from delta_tpu.ops import join_kernel as jax_jk
from delta_tpu.utils.jaxcompat import enable_x64
from delta_tpu_torch.ops import join_kernel as jk


def _same(a, b):
    assert np.array_equal(a.t_first_s, b.t_first_s)
    assert np.array_equal(a.s_matched, b.s_matched)
    assert a.any_multi == b.any_multi


def _link_case():
    """test_link.py's `test_budget_accepts_on_fast_link` data, no budget."""
    rng = np.random.RandomState(0)
    t = rng.randint(0, 1000, 50_000).astype(np.int64)
    s = rng.randint(500, 1500, 5_000).astype(np.int64)
    return t, np.ones(len(t), bool), s, np.ones(len(s), bool)


def _no_room_case():
    """test_link.py's `test_host_join_fallback_when_no_sentinel_room` data."""
    info = np.iinfo(np.int64)
    t = np.array([info.min, info.min + 1, 5, info.max - 1, info.max], np.int64)
    t_ok = np.array([True, True, True, True, True])
    s = np.array([info.min, 5, 7, info.max], np.int64)
    s_ok = np.array([True, True, False, True])
    return t, t_ok, s, s_ok


def _nulls_case():
    rng = np.random.RandomState(5)
    t = rng.randint(-300, 300, 4000).astype(np.int64)
    s = rng.randint(-400, 400, 700).astype(np.int64)
    return t, rng.rand(4000) > 0.1, s, rng.rand(700) > 0.2


def _wide_case():
    rng = np.random.RandomState(6)
    t = rng.randint(-(1 << 62), 1 << 62, 3000).astype(np.int64)
    s = np.concatenate([t[rng.randint(0, 3000, 200)], rng.randint(0, 1 << 40, 100)])
    return t, np.ones(3000, bool), s, rng.rand(300) > 0.1


CASES = {"link": _link_case, "no_room": _no_room_case, "nulls": _nulls_case,
         "wide": _wide_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_inner_join_matches_jax(case):
    t, t_ok, s, s_ok = CASES[case]()
    got = jk.inner_join(t, t_ok, s, s_ok, device="cpu")
    _same(got, jax_jk.inner_join(t, t_ok, s, s_ok))
    assert (got.t_matched == (np.isin(t, s[s_ok]) & t_ok)).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_join_matches_jax(case):
    t, t_ok, s, s_ok = CASES[case]()
    _same(jk._host_join(t, t_ok, s, s_ok), jax_jk._host_join(t, t_ok, s, s_ok))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sentinel_encode_matches_jax(case, dtype):
    t, t_ok, s, s_ok = CASES[case]()
    info = np.iinfo(dtype)
    if t[t_ok].size and (t[t_ok].min() < info.min or t[t_ok].max() > info.max):
        t, s = t.astype(dtype), s.astype(dtype)  # wrap, as a narrow caller would
    t, s = np.where(t_ok, t, 0).astype(dtype), np.where(s_ok, s, 0).astype(dtype)
    got = jk._sentinel_encode(t, t_ok, s, s_ok, dtype)
    want = jax_jk._sentinel_encode(t, t_ok, s, s_ok, dtype)
    assert (got is None) == (want is None)
    if got is not None:
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype


def _padded(case, dtype):
    """The padded kernel inputs inner_join_async builds for a case."""
    t, t_ok, s, s_ok = CASES[case]()
    enc = jax_jk._sentinel_encode(np.where(t_ok, t, 0).astype(dtype), t_ok,
                                  np.where(s_ok, s, 0).astype(dtype), s_ok, dtype)
    t_enc, s_enc, t_fill, s_fill = enc
    return (jax_jk._pad(t_enc, jax_jk._bucket(len(t)), t_fill),
            jax_jk._pad(s_enc, jax_jk._bucket(len(s)), s_fill))


@pytest.mark.parametrize("case,dtype", [("link", np.int32), ("link", np.int64),
                                        ("nulls", np.int32), ("nulls", np.int64),
                                        ("wide", np.int64)])
def test_join_probe_plain_matches_single_device_kernel(case, dtype):
    t_in, s_in = _padded(case, dtype)
    with enable_x64():
        kernel = jax_jk._single_device_kernel(jax)
        want = [np.asarray(x) for x in kernel(t_in, s_in)]
    got = jk.join_probe_plain(torch.from_numpy(t_in), torch.from_numpy(s_in))
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert bool(got[2][0]) == bool(want[2])
    # the wrapper takes the plain version for tensors on the CPU
    wrapped = jk.join_probe(torch.from_numpy(t_in), torch.from_numpy(s_in))
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def _traffic(kind, dtype, cap_t=1 << 14, n=12_000, cap_s=1 << 11, m=2000, seed=11):
    """Padded kernel inputs of the traffics a hash probe meets (the target's
    sentinel at the top of the range, the source's below it): ``dups`` (one
    source key 600 times, in 5% of the targets), ``miss`` (no target key in
    the source), ``hit`` (every target key in the source) and ``extremes``
    (the type's minimum, which a hash slot cannot hold as its key, its
    minimum + 1, its maximum - 1 and its maximum, on both sides among
    narrow keys)."""
    rng = np.random.RandomState(seed)
    info = np.iinfo(dtype)
    if kind == "dups":
        t = rng.randint(-5000, 5000, n)
        s = np.concatenate([np.full(600, 77), rng.randint(-5000, 5000, m - 600)])
        t[rng.rand(n) < 0.05] = 77
    elif kind == "miss":
        t, s = rng.randint(-5000, 5000, n) * 2, rng.randint(-5000, 5000, m) * 2 + 1
    elif kind == "hit":
        s = rng.randint(-(1 << 30), 1 << 30, m)
        t = s[rng.randint(0, m, n)]
    else:
        ends = np.array([info.min, info.min + 1, info.max - 1, info.max], np.int64)
        s = rng.randint(-300, 300, m).astype(np.int64)
        t = rng.randint(-300, 300, n).astype(np.int64)
        s[::11] = info.min
        s[1::13] = ends[rng.randint(0, 4, len(s[1::13]))]
        t[::7] = ends[rng.randint(0, 4, len(t[::7]))]
    t_in = np.full(cap_t, info.max, dtype)
    t_in[:n] = np.asarray(t, np.int64).astype(dtype)
    s_in = np.full(cap_s, info.max - 1, dtype)
    s_in[:m] = np.asarray(s, np.int64).astype(dtype)
    return t_in, s_in


HASH_TRAFFIC = ["dups", "miss", "hit", "extremes"]


@pytest.mark.parametrize("kind", HASH_TRAFFIC)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_join_probe_plain_matches_single_device_kernel_on_hash_traffic(kind, dtype):
    """K12's plain version (the wrapper on the CPU) against JAX's kernel on
    the traffics the hash table is held to on the card, exactly."""
    t_in, s_in = _traffic(kind, dtype)
    with enable_x64():
        want = [np.asarray(x) for x in jax_jk._single_device_kernel(jax)(t_in, s_in)]
    got = jk.join_probe(torch.from_numpy(t_in), torch.from_numpy(s_in))
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert bool(got[2][0]) == bool(want[2])
    if kind == "miss":
        assert not got[0].any() and not got[1].any()
    if kind == "hit":
        assert np.unpackbits(got[0].numpy())[:12_000].all()


def test_join_probe_refuses_bad_inputs():
    t = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        jk.join_probe(t, torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        jk.join_probe(t, torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_host_equi_join_is_every_pair(n_keys):
    rng = np.random.RandomState(40 + n_keys)
    n, m = 300, 120
    keys = []
    for i in range(n_keys):
        if i == 1:  # a string key
            pool = np.array(["a", "b", "c", "dd"], object)
            tv, sv = pool[rng.randint(0, 4, n)], pool[rng.randint(0, 4, m)]
        else:
            tv, sv = rng.randint(0, 6, n).astype(np.int64), rng.randint(0, 6, m).astype(np.int64)
        keys.append((tv, rng.rand(n) > 0.1, sv, rng.rand(m) > 0.1))
    pt, ps = jk.host_equi_join(keys)
    want = [(i, j) for i in range(n) for j in range(m)
            if all(tok[i] and sok[j] and tv[i] == sv[j] for tv, tok, sv, sok in keys)]
    assert list(zip(pt.tolist(), ps.tolist())) == want
