"""The port's cross-replica KV block streaming (flexflow_tpu_torch/
serving/kv_transfer.py): every case of tests/test_kv_transfer.py
mirrored (the FFKV frame's per-block crc verification, content keys,
the in-process and blob-store fabrics, the --kv-transfer gate, the
KVMigrator's exactly-once on_done), then the port held against the
reference: frames packed by either package unpack in the other with
equal headers and arrays, content keys are equal, and KVPool's
export/adopt/drop half gives the reference pool's tables, stats and
invariants over the same operations."""

import json
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from flexflow_tpu.serving import kv_pool as jax_pool  # noqa: E402
from flexflow_tpu.serving import kv_transfer as jax_kvt  # noqa: E402
from flexflow_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from flexflow_tpu_torch.serving import kv_pool as port_pool  # noqa: E402
from flexflow_tpu_torch.serving import kv_transfer as port_kvt  # noqa: E402
from flexflow_tpu_torch.serving.kv_pool import KVPool  # noqa: E402
from flexflow_tpu_torch.serving.kv_transfer import (  # noqa: E402
    BlobStoreFabric, InProcessFabric, KVMigrator, KVTransferError,
    content_key, pack_kv_blocks, resolve_kv_transfer, unpack_kv_blocks)


def _blocks(n, seed=0, shape=(4, 2)):
    rng = np.random.RandomState(seed)
    return [{"attn_0/k": rng.randn(*shape).astype(np.float32),
             "attn_0/v": rng.randn(*shape).astype(np.float32)}
            for _ in range(n)]


def _pages(prompt, page):
    return [list(prompt[j * page:(j + 1) * page])
            for j in range(len(prompt) // page)]


PROMPT = [3, 5, 7, 2, 9, 4, 1, 8]
PAGE = 4


# -- wire format ---------------------------------------------------------

def test_pack_unpack_roundtrip():
    blocks = _blocks(2)
    data = pack_kv_blocks(_pages(PROMPT, PAGE), blocks, PAGE)
    got, complete = unpack_kv_blocks(data, PROMPT)
    assert complete and len(got) == 2
    for want, have in zip(blocks, got):
        for k in want:
            np.testing.assert_array_equal(want[k], have[k])


def test_truncated_payload_admits_verified_prefix_only():
    blocks = _blocks(2)
    data = pack_kv_blocks(_pages(PROMPT, PAGE), blocks, PAGE)
    torn = data[:len(data) - 8]  # BLOB_PARTIAL_UPLOAD shape: put "ok"
    got, complete = unpack_kv_blocks(torn, PROMPT)
    assert not complete and len(got) == 1  # block 0 intact, 1 torn
    np.testing.assert_array_equal(got[0]["attn_0/k"],
                                  blocks[0]["attn_0/k"])


def test_corrupt_block_stops_the_walk():
    data = bytearray(pack_kv_blocks(_pages(PROMPT, PAGE), _blocks(2),
                                    PAGE))
    data[-4] ^= 0xFF  # flip a byte inside the LAST block's payload
    got, complete = unpack_kv_blocks(bytes(data), PROMPT)
    assert not complete and len(got) == 1


def test_foreign_prompt_rejected_per_block():
    """The header's token pages are checked against the prompt the
    stream claims to serve — a payload for a different prompt can never
    be admitted as this one's prefix."""
    data = pack_kv_blocks(_pages(PROMPT, PAGE), _blocks(2), PAGE)
    other = [9] * len(PROMPT)
    got, complete = unpack_kv_blocks(data, other)
    assert not complete and got == []


def test_mangled_header_raises():
    data = pack_kv_blocks(_pages(PROMPT[:PAGE], PAGE), _blocks(1), PAGE)
    with pytest.raises(KVTransferError, match="magic"):
        unpack_kv_blocks(b"NOPE" + data[4:], PROMPT)
    with pytest.raises(KVTransferError, match="header"):
        unpack_kv_blocks(data[:12], PROMPT)  # magic ok, header cut
    mangled = bytearray(data)
    mangled[10] ^= 0xFF  # inside the JSON header
    with pytest.raises(KVTransferError):
        unpack_kv_blocks(bytes(mangled), PROMPT)


def test_empty_stream_roundtrip():
    data = pack_kv_blocks([], [], PAGE)
    got, complete = unpack_kv_blocks(data, PROMPT)
    assert complete and got == []


def test_content_key_is_prefix_content_address():
    k1 = content_key(PROMPT, 2, PAGE)
    k2 = content_key(list(PROMPT) + [1, 2], 2, PAGE)  # same 2 blocks
    k3 = content_key([9] + PROMPT[1:], 2, PAGE)
    assert k1 == k2 and k1 != k3
    assert content_key(PROMPT, 1, PAGE) != k1  # depth is part of the key


# -- fabrics -------------------------------------------------------------

def test_inprocess_fabric_counts():
    fab = InProcessFabric()
    data = pack_kv_blocks(_pages(PROMPT[:PAGE], PAGE), _blocks(1), PAGE)
    assert fab.transfer("k", data) == data
    assert fab.stats() == {"transfers": 1, "bytes_moved": len(data)}


def test_blobstore_fabric_roundtrip_and_cleanup(tmp_path):
    from flexflow_tpu_torch.store.blobstore import LocalBlobStore

    store = LocalBlobStore(str(tmp_path))
    fab = BlobStoreFabric(store, prefix="kvstream/")
    data = pack_kv_blocks(_pages(PROMPT[:PAGE], PAGE), _blocks(1), PAGE)
    assert fab.transfer("abc", data) == data
    assert fab.kind == "blob" and fab.stats()["transfers"] == 1
    assert store.list("kvstream/") == []  # best-effort delete ran


def test_resolve_kv_transfer_gate(tmp_path):
    assert resolve_kv_transfer("inproc").kind == "inproc"
    assert resolve_kv_transfer("", root=None).kind == "inproc"
    assert resolve_kv_transfer("blob", root=str(tmp_path)).kind == "blob"
    with pytest.raises(ValueError, match="blob store"):
        resolve_kv_transfer("blob")
    with pytest.raises(ValueError, match="unknown kv transfer"):
        resolve_kv_transfer("ftp")


# -- migrator pipeline ---------------------------------------------------

class _Target:
    """ContinuousScheduler-shaped import surface: a real KVPool plus a
    model recording import_block writes; run_on_worker runs inline (the
    test thread IS the worker)."""

    def __init__(self, num_blocks=9, page=PAGE):
        self.pool = KVPool(num_blocks=num_blocks, page_size=page,
                           max_blocks_per_seq=4)
        self.imported = {}
        self.model = self

    def import_block(self, block, arrays):
        self.imported[block] = arrays

    def run_on_worker(self, fn, on_dropped=None):
        fn()


def _wait(pred, timeout=5.0):
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_migrator_success_adopts_and_counts():
    reg = MetricsRegistry()
    mig = KVMigrator(InProcessFabric(), registry=reg)
    target = _Target()
    done = []
    try:
        mig.migrate(prompt=PROMPT, pages=_pages(PROMPT, PAGE),
                    blocks=_blocks(2), page_size=PAGE, target=target,
                    on_done=lambda ok: done.append(ok))
        assert _wait(lambda: done)
    finally:
        mig.close()
    assert done == [True]
    assert len(target.imported) == 2
    assert target.pool.prefix_stats()["imported_blocks"] == 2
    # the adopted prefix is a real cache hit for the migrated prompt
    assert target.pool.cached_prefix_tokens(PROMPT) == len(PROMPT)
    assert reg.counter("serving/kv_migration_done").value == 1
    assert reg.counter("serving/kv_migration_blocks").value == 2
    assert mig.stats()["completed"] == 1


def test_migrator_torn_stream_partial_adopt_counts_failed():
    """A fabric landing truncated bytes: the verified prefix block
    still adopts (a prefix of a prefix is a prefix) but the migration
    counts FAILED — the front re-prefills the remainder."""
    class TearingFabric(InProcessFabric):
        def transfer(self, key, data):
            return super().transfer(key, data)[:-8]

    reg = MetricsRegistry()
    mig = KVMigrator(TearingFabric(), registry=reg)
    target = _Target()
    done = []
    try:
        mig.migrate(prompt=PROMPT, pages=_pages(PROMPT, PAGE),
                    blocks=_blocks(2), page_size=PAGE, target=target,
                    on_done=lambda ok: done.append(ok))
        assert _wait(lambda: done)
    finally:
        mig.close()
    assert done == [False]
    assert len(target.imported) == 1
    assert target.pool.cached_prefix_tokens(PROMPT) == PAGE
    assert reg.counter("serving/kv_migration_failed").value == 1


def test_migrator_fabric_error_fails_once():
    class DeadFabric(InProcessFabric):
        def transfer(self, key, data):
            raise RuntimeError("fabric down")

    reg = MetricsRegistry()
    mig = KVMigrator(DeadFabric(), registry=reg)
    target = _Target()
    done = []
    try:
        mig.migrate(prompt=PROMPT, pages=_pages(PROMPT, PAGE),
                    blocks=_blocks(2), page_size=PAGE, target=target,
                    on_done=lambda ok: done.append(ok))
        assert _wait(lambda: done)
    finally:
        mig.close()
    assert done == [False] and target.imported == {}
    assert reg.counter("serving/kv_migration_failed").value == 1


def test_migrator_failed_device_write_unwinds_adoption():
    class ExplodingTarget(_Target):
        def import_block(self, block, arrays):
            raise RuntimeError("device write failed")

    mig = KVMigrator(InProcessFabric())
    target = ExplodingTarget()
    done = []
    try:
        mig.migrate(prompt=PROMPT, pages=_pages(PROMPT, PAGE),
                    blocks=_blocks(2), page_size=PAGE, target=target,
                    on_done=lambda ok: done.append(ok))
        assert _wait(lambda: done)
    finally:
        mig.close()
    assert done == [False]
    # drop_adopted unwound: no admission can map the unwritten blocks
    assert target.pool.cached_prefix_tokens(PROMPT) == 0
    target.pool.check_invariants()


def test_migrator_close_drains_pending_on_done():
    """Jobs queued but never reached by the worker must still fire
    their on_done — a front-side request would otherwise wait forever
    on a migrator that is gone."""
    mig = KVMigrator(InProcessFabric())
    # retire the worker first so queued jobs are provably unreached
    mig._stop.set()
    mig._jobs.put(None)
    mig._worker.join(timeout=5.0)
    done = []
    mig.migrate(prompt=PROMPT, pages=_pages(PROMPT[:PAGE], PAGE),
                blocks=_blocks(1), page_size=PAGE, target=_Target(),
                on_done=lambda ok: done.append(ok))
    mig.close()
    assert done == [False]
    assert mig.stats()["failed"] == 1


def test_migrator_on_done_exception_never_kills_worker():
    mig = KVMigrator(InProcessFabric())
    target = _Target()
    done = []
    try:
        mig.migrate(prompt=PROMPT, pages=_pages(PROMPT[:PAGE], PAGE),
                    blocks=_blocks(1), page_size=PAGE, target=target,
                    on_done=lambda ok: (_ for _ in ()).throw(
                        RuntimeError("bad hook")))
        mig.migrate(prompt=PROMPT, pages=_pages(PROMPT[:PAGE], PAGE),
                    blocks=_blocks(1), page_size=PAGE, target=_Target(),
                    on_done=lambda ok: done.append(ok))
        assert _wait(lambda: done)  # the second job still completes
    finally:
        mig.close()
    assert done == [True]


# -- against the reference -------------------------------------------------

def _kv_blocks(n, seed=0, layers=2, page=PAGE, heads=2, d=3):
    """Blocks as export_block writes them: "<op>/<k_cache|v_cache>"
    pages of [page, heads, d] float32."""
    rng = np.random.RandomState(seed)
    return [{f"attn_{li}/{k}": rng.randn(page, heads, d).astype(np.float32)
             for li in range(layers) for k in ("k_cache", "v_cache")}
            for _ in range(n)]


def _header(data):
    (hlen,) = struct.unpack("<I", data[4:8])
    return json.loads(data[8:8 + hlen])


@pytest.mark.parametrize("tail", [0, 3])
@pytest.mark.parametrize("packer,unpacker", [
    (jax_kvt, port_kvt), (port_kvt, jax_kvt)])
def test_frames_cross_between_the_packages(packer, unpacker, tail):
    """A frame either package packs (a partial tail page included, a
    trace dict in the header) unpacks in the other: the same bytes, the
    same header, the same arrays, the same trace."""
    toks = list(range(2 * PAGE + tail))
    pages = [toks[j:j + PAGE] for j in range(0, len(toks), PAGE)]
    blocks = _kv_blocks(len(pages))
    trace = {"trace_id": "00ab", "span_id": 7}
    data = packer.pack_kv_blocks(pages, blocks, PAGE, trace=trace)
    other = unpacker.pack_kv_blocks(pages, blocks, PAGE, trace=trace)
    assert data == other
    assert _header(data) == _header(other)
    got, complete = unpacker.unpack_kv_blocks(data, toks)
    assert complete and len(got) == len(blocks)
    for want, have in zip(blocks, got):
        assert sorted(want) == sorted(have)
        for k in want:
            np.testing.assert_allclose(have[k], want[k], rtol=0,
                                       atol=1e-6)
    assert unpacker.frame_trace(data) == trace
    torn, complete = unpacker.unpack_kv_blocks(data[:-5], toks)
    assert not complete and len(torn) == len(blocks) - 1
    with pytest.raises(unpacker.KVTransferError):
        unpacker.unpack_kv_blocks(b"NOPE" + data[4:], toks)


@pytest.mark.parametrize("n_blocks,page", [(0, 4), (1, 4), (2, 4), (3, 2),
                                           (5, 16)])
def test_content_key_equals_the_reference(n_blocks, page):
    rng = np.random.RandomState(n_blocks)
    toks = rng.randint(0, 50257, n_blocks * page + 3).tolist()
    assert (port_kvt.content_key(toks, n_blocks, page)
            == jax_kvt.content_key(toks, n_blocks, page))


def _pool_record(pool):
    with pool._lock:
        tables = {sid: list(t) for sid, t in pool._tables.items()}
        cached = list(pool._cached)
        free = sorted(pool._free)
    return {"tables": tables, "cached": cached, "free": free,
            "stats": pool.prefix_stats(), "used": pool.used_blocks}


def _pool_ops(mod):
    """One sequence of operations on a pool of either package: admit
    and write two sequences (one shares a prefix), export a live
    sequence's written blocks, adopt a foreign prefix (reusing indexed
    boundaries, stopping at capacity), unwind half an adoption, retire
    into the cache; the record after each step."""
    pool = mod.KVPool(num_blocks=14, page_size=PAGE, max_blocks_per_seq=6,
                      prefix_cache=True)
    recs = []
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    assert pool.try_admit(0, 16, prompt=a)
    pool.extend(0, 10, written=0)
    pool.note_written(0, 10)
    recs.append(_pool_record(pool))
    blocks, pages = pool.export_live(0, a[:10])
    recs.append({"export_live": (blocks, pages)})
    with pytest.raises(ValueError, match="only 10 are written"):
        pool.export_live(0, a + [11])
    recs.append({"export_prefix": pool.export_prefix(a)})
    pool.retire(0, tokens=a)
    recs.append(_pool_record(pool))
    b = a[:8] + [20, 21, 22, 23, 24, 25, 26, 27]
    recs.append({"adopt": pool.adopt_prefix(b, 4)})
    recs.append(_pool_record(pool))
    recs.append({"hit": pool.cached_prefix_tokens(b)})
    c = [30 + t for t in range(24)]
    pairs = pool.adopt_prefix(c, 6)
    recs.append({"adopt_c": pairs})
    pool.drop_adopted([blk for _, blk in pairs[len(pairs) // 2:]])
    recs.append(_pool_record(pool))
    pool.check_invariants()
    assert pool.try_admit(1, 20, prompt=b)
    recs.append({"hit_admit": pool.admit_hit_tokens(1)})
    recs.append(_pool_record(pool))
    pool.check_invariants()
    recs.append({"export_prefix_b": pool.export_prefix(b)})
    return recs


def test_pool_export_adopt_drop_equal_the_reference():
    """KVPool's export/adopt half against the reference's pool over the
    same operations: equal tables, free lists, cache order, stats
    (imports and imported_blocks included) and adoption pairs, and both
    pools' invariants hold."""
    assert _pool_ops(port_pool) == _pool_ops(jax_pool)


def test_pool_invariants_catch_a_half_unwound_adoption():
    """check_invariants over adopted blocks: an adoption whose index
    entry went without its cached block (or the reverse) is caught."""
    pool = KVPool(num_blocks=6, page_size=PAGE, max_blocks_per_seq=4)
    pairs = pool.adopt_prefix(PROMPT, 2)
    assert len(pairs) == 2 and pool.prefix_stats()["imported_blocks"] == 2
    pool.check_invariants()
    _, blk = pairs[1]
    key = pool._block_key[blk]
    del pool._index[key]  # the entry gone, the block still cached
    with pytest.raises(AssertionError, match="reachable"):
        pool.check_invariants()
