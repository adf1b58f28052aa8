"""Port parity: the exact key directory (``ops/keydir.py``) against the
JAX package's, case by case of ``tests/test_keydir.py``.

Each case gives both packages the same keys (numpy, from a seed) and holds
the port to the JAX package bit for bit: the slots and the admitted mask
of every call, and every directory leaf (``keys`` uint32, ``slots`` and
``free`` int32, ``free_top``) after it. There is no tolerance: admission
is integer work, and both packages grant the same slots in the same
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from real_time_fraud_detection_system_tpu.ops import keydir as jkd
from real_time_fraud_detection_system_tpu_torch.ops import keydir as tkd

torch.set_num_threads(1)

CPU = torch.device("cpu")
# jitted JAX twins: the same results as eager (tests/test_keydir.py pins
# that), without op-by-op dispatch
J_ADMIT = jax.jit(jkd.admit_slots, static_argnames="n_probes")
J_LOOKUP = jax.jit(jkd.lookup_slots, static_argnames="n_probes")
J_RECLAIM = jax.jit(jkd.reclaim_entries)


class Pair:
    """One directory in each package, driven in lockstep and compared
    leaf for leaf after every call."""

    def __init__(self, dir_cap: int, slot_cap: int, n_probes: int = 8):
        self.j = jkd.init_keydir(dir_cap, slot_cap)
        self.t = tkd.init_keydir(dir_cap, slot_cap, CPU)
        self.n_probes = n_probes

    def check(self) -> None:
        np.testing.assert_array_equal(
            self.t.keys.numpy(), np.asarray(self.j.keys), err_msg="keys")
        for name in ("slots", "free", "free_top"):
            np.testing.assert_array_equal(
                getattr(self.t, name).numpy(),
                np.asarray(getattr(self.j, name)), err_msg=name)

    def admit(self, keys, valid=None):
        keys = np.asarray(keys, np.uint32)
        valid = (np.ones(keys.shape, bool) if valid is None
                 else np.asarray(valid, bool))
        self.j, js, ja = J_ADMIT(self.j, jnp.asarray(keys),
                                 jnp.asarray(valid), n_probes=self.n_probes)
        out = tkd.admit_slots(self.t, torch.from_numpy(keys.copy()),
                              torch.from_numpy(valid.copy()), self.n_probes)
        assert out[0] is self.t  # updated in place
        ts, ta = out[1].numpy(), out[2].numpy()
        np.testing.assert_array_equal(ts, np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(ta, np.asarray(ja))
        self.check()
        return ts, ta

    def reclaim(self, dead):
        dead = np.asarray(dead, bool)
        self.j, jd, jn = J_RECLAIM(self.j, jnp.asarray(dead))
        _, td, tn = tkd.reclaim_entries(self.t, torch.from_numpy(dead))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert int(tn) == int(jn)
        self.check()
        return int(tn)

    def lookup(self, keys, valid=None):
        keys = np.asarray(keys, np.uint32)
        valid = (np.ones(keys.shape, bool) if valid is None
                 else np.asarray(valid, bool))
        js, jh = J_LOOKUP(self.j, jnp.asarray(keys), jnp.asarray(valid),
                          n_probes=self.n_probes)
        ts, th = tkd.lookup_slots(self.t, torch.from_numpy(keys.copy()),
                                  torch.from_numpy(valid.copy()),
                                  self.n_probes)
        np.testing.assert_array_equal(ts.numpy(),
                                      np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        self.check()  # a lookup never writes
        return ts.numpy(), th.numpy()

    def occupied(self) -> int:
        occ = int(tkd.occupied_slots(self.t))
        assert occ == int(jkd.occupied_slots(self.j))
        return occ


def test_init_keydir_matches_jax_leaves():
    p = Pair(64, 24)
    p.check()
    assert p.t.keys.dtype == torch.uint32 and p.t.free_top.shape == ()
    assert (p.t.dir_capacity, p.t.slot_capacity) == (64, 24)
    with pytest.raises(ValueError, match="power of 2"):
        tkd.init_keydir(48, 8, CPU)
    with pytest.raises(ValueError, match="more slots"):
        tkd.init_keydir(8, 16, CPU)


def test_admit_assigns_unique_slots_and_coalesces_duplicates():
    p = Pair(64, 16)
    slot, adm = p.admit([5, 5, 7, 9, 5, 11])
    assert adm.all()
    assert slot[0] == slot[1] == slot[4]
    assert len({slot[0], slot[2], slot[3], slot[5]}) == 4
    assert p.occupied() == 4


def test_admit_is_stable_across_batches():
    p = Pair(64, 16)
    s1, _ = p.admit([100, 200, 300])
    s2, adm = p.admit([300, 100, 200])
    np.testing.assert_array_equal(s2, s1[[2, 0, 1]])
    assert adm.all() and p.occupied() == 3


def test_admission_bounded_by_free_list_then_recovers():
    """Free-list exhaustion: past the stack height claims roll back, a
    full table still serves its keys, and a reclaim of everything makes
    room again."""
    p = Pair(64, 8)
    _, adm = p.admit(np.arange(12))
    assert int(adm.sum()) == 8 and int(p.t.free_top) == 0
    _, adm2 = p.admit([0, 999])
    assert adm2[0] and not adm2[1]
    assert p.reclaim(np.ones(64, bool)) == 8
    assert int(p.t.free_top) == 8
    _, adm3 = p.admit(np.arange(8))
    assert adm3.all()


def test_invalid_rows_never_place():
    p = Pair(64, 16)
    _, adm = p.admit([1, 2, 3], valid=[True, False, True])
    assert not adm[1] and p.occupied() == 2
    _, hit = p.lookup([2])
    assert not hit[0]


def test_lookup_is_read_only_and_exact():
    p = Pair(64, 16)
    slot, _ = p.admit([42, 43])
    got, hit = p.lookup([43, 42, 44])
    assert hit[0] and hit[1] and not hit[2]
    np.testing.assert_array_equal(got[:2], slot[[1, 0]])
    assert p.occupied() == 2


def test_reclaim_frees_entries_and_slots_consistently():
    p = Pair(64, 16)
    slot, _ = p.admit([1, 2, 3, 4])
    assert p.reclaim(p.t.slots.numpy() == slot[1]) == 1
    assert p.occupied() == 3
    _, hit = p.lookup([2])
    assert not hit[0]
    _, hit = p.lookup([1, 3, 4])
    assert hit.all()
    _, adm = p.admit([50])
    assert adm[0]


def test_readmission_survives_probe_prefix_vacancy():
    """A reclaimed entry on a live key's probe prefix must not make
    re-admission duplicate the key: the insert looks up the full probe
    depth before it claims anything."""
    p = Pair(64, 32)
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 10_000, 24).astype(np.uint32)
    slot0, adm0 = p.admit(keys)
    assert adm0.all()
    occ0 = p.occupied()
    live = np.flatnonzero(p.t.slots.numpy() >= 0)
    dead = np.zeros(64, bool)
    dead[live[::2]] = True
    freed = set(p.t.slots.numpy()[dead].tolist())
    p.reclaim(dead)
    slot1, adm1 = p.admit(keys)
    assert adm1.all()
    for s0, s1 in zip(slot0.tolist(), slot1.tolist()):
        if s0 not in freed:
            assert s1 == s0
    stored = p.t.keys.numpy()[p.t.slots.numpy() >= 0]
    assert len(stored) == len(np.unique(stored))
    assert p.occupied() == occ0


def test_sentinel_key_is_remapped_not_lost():
    p = Pair(64, 16)
    _, adm = p.admit([0xFFFFFFFF, 0xFFFFFFFE, 0, 2 ** 31, 2 ** 31 - 1])
    assert adm[0] and adm[1]
    _, hit = p.lookup([0xFFFFFFFF])
    assert hit[0]
    assert not np.any(p.t.keys.numpy()[p.t.slots.numpy() >= 0]
                      == np.uint32(0xFFFFFFFF))


@pytest.mark.parametrize("n_probes", [1, 2, 8])
def test_several_batches_match_jax(n_probes):
    """Several batches of duplicates, uint32 edge keys (the int32 view
    flips sign at 2^31), invalid rows and probe overflow (a crowded
    directory at few probes), with reclaims between them."""
    p = Pair(128, 48, n_probes)
    rng = np.random.default_rng(n_probes)
    for step in range(6):
        keys = rng.integers(0, 2 ** 32, 96, dtype=np.uint64).astype(
            np.uint32)
        keys[:24] = rng.integers(0, 40, 24)  # a hot set, duplicated
        keys[24:28] = [2 ** 31 - 1, 2 ** 31, 0xFFFFFFFE, 0xFFFFFFFF]
        p.admit(keys, valid=rng.random(96) < 0.9)
        p.lookup(keys[:32])
        if step % 2:
            p.reclaim(rng.random(128) < 0.3)


@pytest.mark.parametrize("n_keys,slot_cap", [(500, 512), (2000, 256)])
def test_admission_exactness_property(n_keys, slot_cap):
    """Random stream: every admitted key maps to one slot, always the same
    one; occupancy equals the distinct admitted keys."""
    p = Pair(2 * 1024, slot_cap)
    rng = np.random.default_rng(7)
    seen = {}
    for _ in range(6):
        keys = rng.integers(0, n_keys, 256).astype(np.uint32)
        slot, adm = p.admit(keys)
        for k, s, a in zip(keys.tolist(), slot.tolist(), adm.tolist()):
            if a:
                assert seen.setdefault(k, s) == s
    slots = list(seen.values())
    assert len(set(slots)) == len(slots) <= slot_cap
    assert p.occupied() == len(seen)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.lists(st.integers(0, 60), min_size=1, max_size=40),
                min_size=1, max_size=4),
       st.integers(0, 2 ** 16))
def test_admission_matches_jax_property(batches, seed):
    """Hypothesis: any stream of small batches over a crowded directory
    (with reclaims between them) leaves both packages' directories equal
    bit for bit, and the port's mapping is a function of the key. Batches
    pad to 40 rows with invalid rows (one compiled JAX shape)."""
    p = Pair(32, 12, n_probes=3)
    rng = np.random.default_rng(seed)
    for keys in batches:
        n = len(keys)
        padded = np.zeros(40, np.uint32)
        padded[:n] = keys
        slot, adm = p.admit(padded, valid=np.arange(40) < n)
        k_adm = padded[adm]
        for k in set(k_adm.tolist()):
            assert len(set(slot[adm][k_adm == k])) == 1
        p.reclaim(rng.random(32) < 0.25)
