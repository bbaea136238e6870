"""The port's native data plane against the JAX package's, on the CPU.

The port's C++ fill (``sdumc_tpu_torch/csrc/sdumc_data.cc`` through
``data/native.py``) is held to the JAX package's (``native/sdumc_data.cc``,
built by ``native/build.sh``'s command into a temporary directory and
pointed at by monkeypatching ``sdumc_tpu.data.native``: nothing is written
under ``native/``; the fixtures are test_torch_packed.py's) to the bit: ``.npy`` fills (f32, f64, 1-D, an overlong
clip), packed fills at f32, bf16 and int8, fresh and refilled in place,
stale buffers, missing files. Against the port's plain numpy fill: bf16
and int8 to the bit, f32 pooled rows at the JAX package's rtol 1e-6 / atol
1e-7 (numpy's mean divides where the C++ multiplies by 1 / pool),
unpooled rows equal. ``BatchIterator``'s native, ring-buffer and
``length_pool`` paths give JAX's batches; the header readers JAX's shapes;
a build without a compiler raises. Last, ``cli.train`` for two epochs on
an ``.npy`` dataset and on a packed store logs the plain path's losses to
the bit, its batches filled by the C++ library.
"""

import ast
import functools
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sdumc_tpu.data.feature_store import NpyDirSource as JaxNpyDirSource
from sdumc_tpu.data.feature_store import npy_header_shape as jax_npy_header_shape
from sdumc_tpu.data.packed import PackedSource as JaxPackedSource
from sdumc_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from sdumc_tpu.data.pipeline import MoseiDataset as JaxDataset
from sdumc_tpu_torch.data import native, pipeline
from sdumc_tpu_torch.data.feature_store import NpyDirSource, SyntheticSource, npy_header_shape
from sdumc_tpu_torch.data.packed import (PackedSource, fill_batch_from_packed,
                                         fill_batch_from_packed_plain, pack_features)
from sdumc_tpu_torch.data.pipeline import BatchIterator, MoseiDataset
from sdumc_tpu_torch.ops.kernels import build
from tests.test_torch_packed import (DIMS, FEATURES, MODALITIES, _labels, _payload,  # noqa: F401
                                     jax_cpp, jax_library, jax_python, write_clips)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DTYPES = ("float32", "bfloat16", "int8")
RING_LENGTHS = (2, 39, 7, 16, 33, 1, 12, 25, 9, 40, 3, 18, 31, 6, 22, 14)


def _bits(a) -> np.ndarray:
    """A batch as numpy, bf16 (a torch tensor, or ml_dtypes) as uint16 bits."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
    return _payload(a)


def _all_ones(shape, dtype) -> np.ndarray:
    """An array of `shape` and `dtype` whose every byte is 0xFF."""
    return np.full(int(np.prod(shape)) * np.dtype(dtype).itemsize, 0xFF, np.uint8).view(
        dtype).reshape(shape)


def _jax_dtype(dtype):
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16) if dtype == "bfloat16" else np.dtype(dtype)


@pytest.fixture(scope="module")
def npy_files(tmp_path_factory):
    """Seeded clips of 24 channels as .npy: f32, f64, a 1-D [24] vector, one
    overlong for a 16 bucket (37 frames), one of 16 and one of 48."""
    root = tmp_path_factory.mktemp("npy")
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.normal(size=(5, 24)).astype(np.float32),
              "f64": rng.normal(size=(9, 24)),
              "vec": rng.normal(size=(24,)).astype(np.float32),
              "long": (rng.normal(size=(37, 24)) * 3).astype(np.float32),
              "edge": rng.normal(size=(16, 24)).astype(np.float32),
              "longer": rng.normal(size=(48, 24)).astype(np.float32)}
    for name, a in arrays.items():
        np.save(root / f"{name}.npy", a)
    return {name: str(root / f"{name}.npy") for name in arrays}


def test_fill_batch_matches_jax_cpp(npy_files, jax_cpp):
    paths = list(npy_files.values())
    got, lens = native.fill_batch(paths, 16, 24)
    ref, ref_lens = jax_cpp.fill_batch(paths, 16, 24)
    assert got.dtype == np.float32 and got.shape == (6, 16, 24)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(lens, ref_lens)
    assert list(lens) == [5, 9, 1, 16, 16, 16]
    # into a stale buffer, as numpy and as a torch tensor: the same bits
    stale = np.full((6, 16, 24), np.nan, np.float32)
    out, _ = native.fill_batch(paths, 16, 24, out=stale)
    assert out is stale
    np.testing.assert_array_equal(out, ref)
    t = torch.full((6, 16, 24), float("nan"))
    assert native.fill_batch(paths, 16, 24, out=t)[0] is t
    np.testing.assert_array_equal(t.numpy(), ref)


def test_fill_batch_matches_the_plain_collate(npy_files):
    """Against numpy's padding and mean pool: unpooled clips equal, the two
    pooled ones at the JAX package's rtol 1e-6 / atol 1e-7."""
    from sdumc_tpu_torch.data.collate import mapping_feature

    got, _ = native.fill_batch(list(npy_files.values()), 16, 24)
    for i, (name, path) in enumerate(npy_files.items()):
        a = np.asarray(np.load(path), np.float32).reshape(-1, 24)
        want = np.zeros((16, 24), np.float32)
        mapped = mapping_feature(a, 16) if len(a) > 16 else a
        want[: len(mapped)] = mapped
        if len(a) > 16:
            np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(got[i], want, err_msg=name)


def test_missing_files_raise(tmp_path, npy_files, jax_cpp):
    paths = [npy_files["f32"], str(tmp_path / "nope.npy")]
    with pytest.raises(IOError):
        native.fill_batch(paths, 8, 24)
    with pytest.raises(IOError):
        jax_cpp.fill_batch(paths, 8, 24)
    with pytest.raises(IOError):
        native.fill_batch_packed(str(tmp_path / "nope.bin"), [(0, 2, 24)], 8, 24)
    with pytest.raises(IOError):                 # more channels than the batch holds
        native.fill_batch([npy_files["f32"]], 8, 16)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{dtype: PackedSource} of one seeded clip directory (LENGTHS: 17, 30
    and 25 overflow a 16 bucket, one [24] vector, bf16 ties) packed by the
    port at each dtype; and the clip names."""
    root = tmp_path_factory.mktemp("stores")
    names = write_clips(root / "clips", 24)
    return names, {d: PackedSource(pack_features(str(root / "clips"), str(root / d), dtype=d))
                   for d in DTYPES}


@pytest.mark.parametrize("dtype", DTYPES)
def test_fill_batch_packed_matches_jax_cpp(stores, jax_cpp, dtype):
    """Fresh, then refilled in place four times with the previous fill's
    lengths (the ring's partial pad zeroing), the tuple and the array forms
    of the entries: the port's C++ fill equals JAX's to the bit."""
    names, srcs = stores
    src = srcs[dtype]
    picks = [names[:7], names[3:10], names[::-1][:7], names[1:8], [names[2]] * 7]
    out = jax_out = prev = jax_prev = None
    for bucket in (16, 32):
        for pick in picks:
            entries = [tuple(src._index[n][:3]) for n in pick]
            got, lens = native.fill_batch_packed(src.bin_path, entries, bucket, 24, dtype,
                                                 out=out, prev_lengths=prev)
            ref, ref_lens = jax_cpp.fill_batch_packed(src.bin_path, entries, bucket, 24,
                                                      dtype=dtype, out=jax_out,
                                                      prev_lengths=jax_prev)
            assert got.dtype == src.payload_dtype and got.shape == (7, bucket, 24)
            np.testing.assert_array_equal(got, _payload(ref))
            np.testing.assert_array_equal(lens, ref_lens)
            fresh, _ = native.fill_batch_packed(src.bin_path, tuple(src.entry_arrays(pick)[:3]),
                                                bucket, 24, dtype)
            np.testing.assert_array_equal(fresh, got)
            out, prev, jax_out, jax_prev = got, lens, ref, ref_lens
        out = jax_out = prev = jax_prev = None


@pytest.mark.parametrize("dtype", DTYPES)
def test_stale_buffer_is_overwritten_in_every_byte(stores, jax_cpp, dtype):
    """A buffer of all-ones bytes (NaN at f32 and bf16) given without
    lengths: every byte rewritten, as JAX's fill rewrites its own, and as
    a torch tensor destination."""
    names, srcs = stores
    src = srcs[dtype]
    entries = [tuple(src._index[n][:3]) for n in names[:6]]
    stale = _all_ones((6, 16, 24), src.payload_dtype)
    got, _ = native.fill_batch_packed(src.bin_path, entries, 16, 24, dtype, out=stale)
    assert got is stale
    jax_stale = _all_ones((6, 16, 24), _jax_dtype(dtype))
    ref, _ = jax_cpp.fill_batch_packed(src.bin_path, entries, 16, 24, dtype=dtype, out=jax_stale)
    np.testing.assert_array_equal(got, _payload(ref))
    fresh, _ = native.fill_batch_packed(src.bin_path, entries, 16, 24, dtype)
    np.testing.assert_array_equal(got, fresh)
    if dtype != "int8":
        assert np.isfinite(_f32(got, dtype)).all()
    t = torch.full((6, 16, 24), -1, dtype=native.DTYPES[dtype][2])
    assert native.fill_batch_packed(src.bin_path, entries, 16, 24, dtype, out=t)[0] is t
    np.testing.assert_array_equal(_bits(t), fresh)


def test_a_wrong_destination_raises(stores):
    names, srcs = stores
    entries = [tuple(srcs["bfloat16"]._index[n][:3]) for n in names[:2]]
    path = srcs["bfloat16"].bin_path
    for bad in (np.empty((2, 16, 24), np.float32), np.empty((2, 16, 24), np.uint16)[:, ::2],
                np.empty((2, 8, 24), np.uint16), torch.empty(2, 16, 24)):
        with pytest.raises(ValueError):
            native.fill_batch_packed(path, entries, 16, 24, "bfloat16", out=bad)


def _f32(a, dtype):
    from sdumc_tpu_torch.data.packed import bf16_to_f32

    return bf16_to_f32(a) if dtype == "bfloat16" else a.astype(np.float32)


@pytest.mark.parametrize("bucket", [8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpp_fill_matches_the_plain_fill(stores, dtype, bucket):
    """The port's C++ fill against its plain numpy fill: bf16 and int8 to
    the bit; f32 unpooled rows equal, pooled rows at rtol 1e-6 / atol
    1e-7."""
    names, srcs = stores
    src = srcs[dtype]
    got, lens = fill_batch_from_packed(src, names, bucket)
    ref, ref_lens = fill_batch_from_packed_plain(src, names, bucket)
    np.testing.assert_array_equal(lens, ref_lens)
    pooled = np.array([src.length_of(n) > bucket for n in names])
    if dtype == "float32":
        np.testing.assert_array_equal(got[~pooled], ref[~pooled])
        np.testing.assert_allclose(got[pooled], ref[pooled], rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------ BatchIterator


def _write_npy_dirs(root, lengths, seed=10):
    """Four modality directories of seeded clips (DIMS) under `root`;
    returns the clip names."""
    for i, key in enumerate(MODALITIES):
        names = write_clips(root / key, DIMS[key], lengths, seed=seed + i, prefix="c")
    return names


def _sources(root, kind, dtype=None):
    """(port sources, JAX sources) over the same files: the .npy
    directories, or the packed stores at `dtype` (packed by the port)."""
    if kind == "npy":
        return ({k: NpyDirSource(str(root), k) for k in MODALITIES},
                {k: JaxNpyDirSource(str(root), k) for k in MODALITIES})
    prefixes = {k: str(root / f"{k}_{dtype}") for k in MODALITIES}
    for k, prefix in prefixes.items():
        if not Path(prefix + ".bin").exists():
            pack_features(str(root / k), prefix, dtype=dtype)
    return ({k: PackedSource(p, k) for k, p in prefixes.items()},
            {k: JaxPackedSource(p, k) for k, p in prefixes.items()})


def _assert_batches_equal(got, ref, context=""):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.names == r.names and g.t_max == r.t_max, context
        for key in MODALITIES:
            np.testing.assert_array_equal(getattr(g, key), _payload(getattr(r, key)),
                                          err_msg=f"{context} {key}")
        for key in ("lengths", "vals", "emos"):
            np.testing.assert_array_equal(getattr(g, key), getattr(r, key), err_msg=key)
        if r.scales is None:
            assert g.scales is None
        else:
            for key in MODALITIES:
                np.testing.assert_array_equal(g.scales[key], r.scales[key])


def _copied(it):
    """The iterator's batches, each array copied before the next is asked
    for (the consumer of a ring)."""
    out = []
    for b in it:
        out.append(type(b)(**{**b.__dict__, **{k: getattr(b, k).copy() for k in MODALITIES}}))
    return out


@pytest.mark.parametrize("kind", ["npy", "float32", "bfloat16", "int8"])
def test_batch_iterator_matches_jax_cpp(tmp_path, jax_cpp, kind):
    """On .npy directories and packed stores, shuffled and sharded over 2
    ranks, with prefetch: the port's C++ path gives JAX's C++ path's
    batches to the bit, and the fill ran in C++ on both sides."""
    names = _write_npy_dirs(tmp_path, (5, 17, 1, 30, 9, 12, 3, 25, 8, 14, 6))
    labels = _labels(names)
    port, jax = _sources(tmp_path, "npy" if kind == "npy" else "packed", kind)
    calls = []
    fill = native.fill_batch if kind == "npy" else native.fill_batch_packed
    counted = functools.wraps(fill)(lambda *a, **k: calls.append(1) or fill(*a, **k))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, fill.__name__, counted)
        for shard in (0, 1):
            kw = dict(shuffle=True, seed=3, epoch=1, buckets=(8, 16), shard_index=shard,
                      shard_count=2)
            got = list(BatchIterator(MoseiDataset(names, labels, port), 2, prefetch=2, **kw))
            ref = list(JaxBatchIterator(JaxDataset(names, labels, jax), 2, prefetch=0, **kw))
            _assert_batches_equal(got, ref, f"shard {shard}")
    assert len(calls) == 4 * 6          # 4 streams x 3 batches x 2 shards


@pytest.mark.parametrize("kind", ["npy", "float32", "bfloat16", "int8"])
def test_plain_iterator_matches_jax_python(tmp_path, jax_python, kind):
    """plain=True (make_batch, or the packed store's numpy fill) gives the
    batches of the JAX package's Python path to the bit."""
    names = _write_npy_dirs(tmp_path, (5, 17, 1, 30, 9, 12, 3, 25, 8, 14, 6))
    labels = _labels(names)
    port, jax = _sources(tmp_path, "npy" if kind == "npy" else "packed", kind)
    kw = dict(shuffle=True, seed=4, buckets=(8, 16), prefetch=0)
    got = list(BatchIterator(MoseiDataset(names, labels, port), 4, plain=True, **kw))
    ref = list(JaxBatchIterator(JaxDataset(names, labels, jax), 4, **kw))
    _assert_batches_equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ring_buffers_match_fresh_buffers_and_jax(tmp_path, jax_cpp, dtype):
    """reuse_buffers=3 with prefetch 1 over 3 epochs (each slot refilled by
    other clips: the pad rows past the previous occupant's only are
    zeroed), each batch copied before the next: the batches of fresh
    buffers and of JAX's ring, to the bit; the slots are reused."""
    names = _write_npy_dirs(tmp_path, RING_LENGTHS, seed=13)
    labels = _labels(names)
    port, jax = _sources(tmp_path, "packed", dtype)
    kw = dict(shuffle=True, seed=5, buckets=(8, 16, 32))
    ring = BatchIterator(MoseiDataset(names, labels, port), 4, prefetch=1, reuse_buffers=3, **kw)
    fresh = BatchIterator(MoseiDataset(names, labels, port), 4, prefetch=0, **kw)
    jax_ring = JaxBatchIterator(JaxDataset(names, labels, jax), 4, prefetch=1, reuse_buffers=3,
                                **kw)
    seen = set()
    for epoch in range(3):
        ring.epoch = fresh.epoch = jax_ring.epoch = epoch
        got = _copied(ring)
        _assert_batches_equal(got, list(fresh), f"epoch {epoch}")
        _assert_batches_equal(got, _copied(jax_ring), f"epoch {epoch}")
        seen.update(b.audio.ctypes.data for b in ring)
    slots = sum(len(r) - 1 for r in ring._rings.values())
    assert len(seen) <= slots and max(r[0] for r in ring._rings.values()) > 3


def test_ring_depth_must_cover_the_prefetch_queue():
    """The same arguments raise in the port (ValueError) and in the JAX
    package (AssertionError)."""
    with pytest.raises(ValueError, match="prefetch"):
        BatchIterator(MoseiDataset([], [], {}), 4, shuffle=False, prefetch=4, reuse_buffers=5)
    with pytest.raises(AssertionError):
        JaxBatchIterator(JaxDataset([], [], {}), 4, shuffle=False, prefetch=4, reuse_buffers=5)
    BatchIterator(MoseiDataset([], [], {}), 4, shuffle=False, prefetch=4, reuse_buffers=6)


@pytest.mark.parametrize("kind", ["npy", "bfloat16", "synthetic"])
@pytest.mark.parametrize("pool", [2, 3])
def test_length_pool_gives_jax_order(tmp_path, jax_cpp, kind, pool):
    """length_pool sorts the shuffled order by audio length inside windows
    of `pool` batches (the lengths from the headers, the index, or the
    clips themselves), before the shard slice: JAX's batches."""
    names = _write_npy_dirs(tmp_path, RING_LENGTHS, seed=17)
    labels = _labels(names)
    if kind == "synthetic":
        port = {k: SyntheticSource(k, DIMS[k], 1, 40) for k in MODALITIES}
        jax = port
    else:
        port, jax = _sources(tmp_path, "npy" if kind == "npy" else "packed", kind)
    orders = {}
    for shard_count in (1, 2):
        kw = dict(shuffle=True, seed=7, epoch=2, buckets=(8, 16, 32), length_pool=pool,
                  prefetch=0, shard_count=shard_count)
        got = list(BatchIterator(MoseiDataset(names, labels, port), 3, **kw))
        ref = list(JaxBatchIterator(JaxDataset(names, labels, jax), 3, **kw))
        if kind == "synthetic":
            assert [g.names for g in got] == [r.names for r in ref]
        else:
            _assert_batches_equal(got, ref, f"{shard_count} shards")
        orders[shard_count] = [g.names for g in got]
    unpooled = BatchIterator(MoseiDataset(names, labels, port), 3, shuffle=True, seed=7,
                             epoch=2, buckets=(8, 16, 32), prefetch=0)
    assert orders[1] != [u.names for u in unpooled]


# ----------------------------------------------------------- header readers


@pytest.fixture(scope="module")
def headers(tmp_path_factory):
    """.npy files of format 1 and 2 (2-D), and a 1-D one, f32 and f64."""
    root = tmp_path_factory.mktemp("headers")
    rng = np.random.default_rng(2)
    arrays = {"v1": rng.normal(size=(11, 6)).astype(np.float32), "v2": rng.normal(size=(4, 6)),
              "vec": rng.normal(size=(6,)).astype(np.float32)}
    for name, a in arrays.items():
        with open(root / f"{name}.npy", "wb") as f:
            np.lib.format.write_array(f, a, version=(2, 0) if name == "v2" else (1, 0))
    assert (root / "v2.npy").read_bytes()[6] == 2
    return root, arrays


def test_header_readers_match_jax(headers):
    root, arrays = headers
    port, jax = NpyDirSource(str(root.parent), root.name), JaxNpyDirSource(str(root.parent),
                                                                           root.name)
    assert port.dim == jax.dim == 6
    for name, a in arrays.items():
        path = port.path_for(name)
        assert path == jax.path_for(name)
        assert npy_header_shape(path) == jax_npy_header_shape(path) == a.shape
        assert port.length_of(name) == jax.length_of(name) == (len(a) if a.ndim > 1 else 1)
        np.testing.assert_array_equal(port.get(name), jax.get(name))


def test_preload_fills_the_cache_as_jax(headers):
    root, arrays = headers
    port = NpyDirSource(str(root.parent), root.name, preload_names=list(arrays))
    jax = JaxNpyDirSource(str(root.parent), root.name, preload_names=list(arrays))
    assert list(port._cache) == list(jax._cache) == list(arrays)
    for name in arrays:
        assert port.get(name) is port._cache[name]
        np.testing.assert_array_equal(port.get(name), jax.get(name))
        assert port.get(name).dtype == np.float32
    assert port.dim == jax.dim == 6


def test_synthetic_source_without_cache_gives_the_same_clips():
    cached, bare = SyntheticSource("audio", 8, 2, 9, seed=3), SyntheticSource(
        "audio", 8, 2, 9, seed=3, cache=False)
    a, b = cached.get("c1"), bare.get("c1")
    np.testing.assert_array_equal(a, b)
    assert cached.get("c1") is a and bare.get("c1") is not b and bare._cache is None


# ------------------------------------------------------------------ the build


def test_no_compiler_raises(tmp_path, monkeypatch):
    """With no g++ on PATH and no library built, load_library raises; so
    does the .npy iterator, which has no numpy fallback."""
    (tmp_path / "bin").mkdir()
    monkeypatch.setattr(build, "NATIVE_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_library()
    names = _write_npy_dirs(tmp_path / "clips", (3, 4))
    ds = MoseiDataset(names, _labels(names), _sources(tmp_path / "clips", "npy")[0])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        list(BatchIterator(ds, 2, shuffle=False, prefetch=0))
    assert not (tmp_path / "native").exists() or not list((tmp_path / "native").iterdir())


def test_a_failed_compile_raises_with_the_compilers_message(tmp_path, monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "sdumc_data.cc").write_text("int broken( {\n")
    monkeypatch.setattr(build, "PACKAGE_DIR", tmp_path)
    monkeypatch.setattr(build, "NATIVE_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="sdumc_data.cc.*error"):
        build.load("sdumc_data")
    assert list((tmp_path / "native").iterdir()) == []      # no temporary file left


def test_the_library_name_follows_its_source_not_the_headers(tmp_path, monkeypatch):
    shutil.copytree(build.PACKAGE_DIR / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(build, "PACKAGE_DIR", tmp_path)
    before = build.library_path("sdumc_data")
    assert before.parent == build.NATIVE_DIR and before.name.startswith("libsdumc_data-")
    (tmp_path / "csrc" / "tf32x3.cuh").write_text("// edited\n")
    assert build.library_path("sdumc_data") == before
    with open(tmp_path / "csrc" / "sdumc_data.cc", "a") as f:
        f.write("// edited\n")
    assert build.library_path("sdumc_data") != before
    assert "sdumc_data" in build.build.__defaults__[0]    # the script builds it too


def test_the_binding_imports_only_ctypes_numpy_torch_and_the_port():
    tree = ast.parse((REPO / "sdumc_tpu_torch" / "data" / "native.py").read_text())
    mods = {(n.module if isinstance(n, ast.ImportFrom) else a.name).split(".")[0]
            for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in (n.names if isinstance(n, ast.Import) else [n])}
    assert mods <= {"__future__", "ctypes", "os", "typing", "numpy", "torch",
                    "sdumc_tpu_torch"}, mods


def test_the_library_reports_its_version():
    assert native.load_library().sdumc_version() == 3


# --------------------------------------------------------------- end to end


def _write_npy_dataset(root):
    """A tiny dataset in PathsConfig.from_env's layout: .npy directories
    under features/CMU-MOSEI (DataConfig's feature names) and the labels."""
    from tests.test_torch_packed import write_dataset

    write_dataset(root, "float32")
    features = root / "features" / "CMU-MOSEI"
    for key in MODALITIES:
        for ext in (".bin", ".json"):
            (features / (FEATURES[key] + ext)).unlink()
        shutil.move(str(root / "npy" / FEATURES[key]), str(features / FEATURES[key]))


@pytest.mark.parametrize("store", ["npy", "int8"])
def test_cli_train_native_equals_plain(tmp_path, monkeypatch, store):
    """cli.train --device cpu for two epochs: through the C++ fill (counted)
    and through the plain path (BatchIterator(plain=True) in the loop), the
    same logged losses and metrics to the bit."""
    from sdumc_tpu_torch.cli import train
    from sdumc_tpu_torch.train import loop
    from tests.test_torch_packed import write_dataset

    if store == "npy":
        _write_npy_dataset(tmp_path / "data")
    else:
        write_dataset(tmp_path / "data", store)
    monkeypatch.setenv("SDUMC_DATA_DIR", str(tmp_path / "data"))
    name = "fill_batch" if store == "npy" else "fill_batch_packed"
    fill, calls = getattr(native, name), []
    monkeypatch.setattr(native, name, lambda *a, **k: calls.append(1) or fill(*a, **k))
    histories = {}
    for path in ("native", "plain"):
        if path == "plain":
            monkeypatch.setattr(loop, "BatchIterator",
                                functools.partial(pipeline.BatchIterator, plain=True))
        calls.clear()
        result = train.main(["--device", "cpu", "--batch_size", "4", "--layers", "16,8",
                             "--epochs", "2", "--save_root", str(tmp_path / path),
                             "--checkpoint_dir", str(tmp_path / path / "ck")])
        # 2 epochs x (2 train + 1 val + 2 test batches) x 4 streams
        assert len(calls) == (40 if path == "native" else 0), path
        histories[path] = result["history"]
    for got, ref in zip(*histories.values()):
        for key in ("train_loss", "train_mse_full", "train_mse_missing", "eval_mse_full"):
            assert got[key] == ref[key], key
        assert got["test"] == ref["test"]
