"""The dataset half of the input pipeline in paddle_tpu_torch against
paddle_tpu: ``fluid_dataset.py``, ``native/`` (RecordIO and the MultiSlot
parser), ``recordio_writer.py``, ``incubate/data_generator.py`` and the
synthetic ``dataset/`` readers.

* The same MultiSlot files give equal batches (every key, dtype, shape
  and value, exactly) from both packages: ``InMemoryDataset`` after a
  seeded ``global_shuffle``, and ``QueueDataset``; dense slots are
  ``[B, -1]``, a slot of a ``lod_level`` var is padded with its
  ``_seq_len`` companion.
* The native parser and the Python fallback agree on malformed lines,
  exactly, in the port; and the port's parser agrees with the JAX
  package's on the same text.
* A RecordIO file written by either package reads in the other (both
  build the same ``recordio.cc``), also through
  ``recordio_writer.convert_reader_to_recordio_file``.
* ``MultiSlotDataGenerator`` writes the same text, and every synthetic
  reader of ``dataset/`` yields the same samples, exactly.
"""
import io

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import native as jnative
from paddle_tpu_torch import native as tnative

PKG = {"jax": jfluid, "torch": tfluid}
F = 5  # fields of the CTR lines


def _ctr_lines(rng, n, bad_every=0):
    """MultiSlot CTR text: F ids, F values, a label per line; every
    ``bad_every``-th line malformed (an id that is not a number)."""
    out = []
    for i in range(n):
        ids = rng.randint(0, 1000, F)
        vals = rng.uniform(0, 1, F).round(4)
        line = "%d %s %d %s 1 %d" % (F, " ".join(map(str, ids)), F,
                                     " ".join(map(str, vals)), rng.randint(0, 2))
        if bad_every and i % bad_every == bad_every - 1:
            line = line.replace(str(ids[0]), "x", 1)
        out.append(line)
    return "\n".join(out) + "\n"


def _files(tmp_path, n_files=2, lines=37):
    rng = np.random.RandomState(1234)
    paths = []
    for i in range(n_files):
        p = tmp_path / ("part-%d" % i)
        p.write_text(_ctr_lines(rng, lines, bad_every=9))
        paths.append(str(p))
    return paths


def _dataset(pkg, kind, paths, batch=8, shuffle_seed=None):
    fluid = PKG[pkg]
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), fluid.unique_name.guard():
        ids = fluid.layers.data("feat_ids", [F, 1], dtype="int64")
        vals = fluid.layers.data("feat_vals", [F], dtype="float32")
        label = fluid.layers.data("label", [1], dtype="int64")
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_use_var([ids, vals, label])
    ds.set_batch_size(batch)
    ds.set_filelist(paths)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        if shuffle_seed is not None:
            ds.global_shuffle(seed=shuffle_seed)
    return ds


def _canon(d):
    return np.dtype("int64") if d in (np.int32, np.int64) else d


def _assert_same_batches(jbatches, tbatches):
    assert len(tbatches) == len(jbatches) and tbatches
    for jb, tb in zip(jbatches, tbatches):
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].shape == jb[k].shape, k
            assert _canon(tb[k].dtype) == _canon(jb[k].dtype), k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("kind,seed", [("InMemoryDataset", 0), ("InMemoryDataset", None),
                                       ("QueueDataset", None)])
def test_same_batches_from_both_packages(kind, seed, tmp_path):
    paths = _files(tmp_path)
    jb = list(_dataset("jax", kind, paths, shuffle_seed=seed))
    tb = list(_dataset("torch", kind, paths, shuffle_seed=seed))
    _assert_same_batches(jb, tb)
    # 2 x 37 lines, 4 of each file's malformed, in batches of 8
    assert len(tb) == (2 * (37 - 4)) // 8 if kind == "InMemoryDataset" else len(tb) == 2 * 4
    assert tb[0]["feat_ids"].shape == (8, F) and tb[0]["feat_ids"].dtype == np.int64
    assert tb[0]["label"].shape == (8, 1)


def test_inmemory_memory_size_and_release(tmp_path):
    paths = _files(tmp_path)
    ds = _dataset("torch", "InMemoryDataset", paths)
    assert ds.get_memory_data_size() == 2 * (37 - 4)
    ds.release_memory()
    assert ds.get_memory_data_size() == 0 and list(ds) == []


def test_lod_slot_padded_with_seq_len(tmp_path):
    """A lod_level slot of ragged length pads to the batch's longest row
    and carries ``<name>_seq_len``, as in the JAX package."""
    (tmp_path / "f").write_text("3 1 2 3 1 0\n1 4 1 1\n2 5 6 1 0\n4 7 8 9 10 1 1\n")
    out = {}
    for pkg, fluid in PKG.items():
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()), fluid.unique_name.guard():
            words = fluid.layers.data("words", [1], dtype="int64", lod_level=1)
            label = fluid.layers.data("label", [1], dtype="int64")
        ds = fluid.DatasetFactory().create_dataset("QueueDataset")
        ds.set_use_var([words, label])
        ds.set_batch_size(2)
        ds.set_filelist([str(tmp_path / "f")])
        out[pkg] = list(ds)
    _assert_same_batches(out["jax"], out["torch"])
    np.testing.assert_array_equal(out["torch"][1]["words_seq_len"], [2, 4])


MALFORMED = [
    b"3 1.0 x 1 5.0\n",
    b"2 1.0 2.0 1 9.0\n3 1.0 x 1 5.0\n",
    b"2 1.0 2.0 1 9.0\n3 1.0 2.0 3.0 1 5.0\n2 0.5 0.5 1 7.0\n",
    b"1 1.0\n2 2.0\n",
    b"2 1.0 2.0 1 3.0\nx y\n2 4.0 5.0 1 6.0\n",
    b"2 1.0\n1 5.0\n",
    b"2 1.0",
    b"-1 1.0 1 2.0\n1 3.0 1 4.0\n",
    b"\n\n1 1.5 1 2.5\n   \n",
]


@pytest.mark.parametrize("text", MALFORMED)
def test_native_and_python_parsers_agree(text):
    assert tnative.native_available()
    n_nat, slots_nat = tnative.parse_multislot(text, 2)
    n_py, slots_py = tnative._parse_multislot_py(text, 2)
    n_jax, slots_jax = jnative.parse_multislot(text, 2)
    assert n_nat == n_py == n_jax, text
    for (vn, cn), (vp, cp), (vj, cj) in zip(slots_nat, slots_py, slots_jax):
        np.testing.assert_array_equal(vn, vp)
        np.testing.assert_array_equal(cn, cp)
        np.testing.assert_array_equal(vn, vj)
        np.testing.assert_array_equal(cn, cj)


def test_native_builds_into_the_port(tmp_path):
    """The port's library lies under paddle_tpu_torch/_build/, not in a
    cache directory it could share with the JAX package."""
    import os

    assert tnative.native_available()
    path = tnative._so_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(os.path.dirname(tfluid.__file__), "_build")


RECORDS = [b"hello", b"", b"x" * 100000, np.arange(100).tobytes(), b"1 2 3"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_recordio_reads_across_packages(writer, reader, tmp_path):
    wn = {"jax": jnative, "torch": tnative}[writer]
    rn = {"jax": jnative, "torch": tnative}[reader]
    path = str(tmp_path / "data.recordio")
    with wn.RecordIOWriter(path, compress=True, max_chunk_bytes=4096) as w:
        for r in RECORDS:
            w.write(r)
    scanner = rn.RecordIOScanner(path)
    try:
        assert list(scanner) == RECORDS
    finally:
        scanner.close()


def test_port_recordio_detects_corruption(tmp_path):
    path = str(tmp_path / "data.recordio")
    with tnative.RecordIOWriter(path, compress=False) as w:
        w.write(b"payload-payload-payload")
    data = bytearray(open(path, "rb").read())
    data[-3] ^= 0xFF
    open(path, "wb").write(bytes(data))
    scanner = tnative.RecordIOScanner(path)
    with pytest.raises(IOError):
        list(scanner)
    scanner.close()


def test_recordio_writer_converts_readers_alike(tmp_path):
    """convert_reader_to_recordio_file(s) of the same reader: the same
    record count and records, read back by the other package."""
    def reader():
        rng = np.random.RandomState(3)
        for _ in range(11):
            yield rng.randint(0, 9, 4), np.float32(rng.uniform()), [1, 2]

    out = {}
    for pkg, fluid in PKG.items():
        path = str(tmp_path / (pkg + ".rio"))
        n = fluid.recordio_writer.convert_reader_to_recordio_file(path, reader)
        counts = fluid.recordio_writer.convert_reader_to_recordio_files(
            str(tmp_path / (pkg + "_shard")), 4, reader)
        other = tnative if pkg == "jax" else jnative
        scanner = other.RecordIOScanner(path)
        out[pkg] = (n, counts, list(scanner))
        scanner.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 11 and out["torch"][1] == [4, 4, 3]


def test_multislot_data_generator_same_text():
    class Gen:
        def generate_sample(self, line):
            def reader():
                ids = [int(t) for t in line.split()]
                yield [("ids", ids), ("label", [ids[0] % 2])]
            return reader

    lines = ["3 4 5", "7", "1 2", "9 9 9 9"]
    texts = {}
    for pkg, fluid in PKG.items():
        gen_cls = type("G", (Gen, fluid.incubate.data_generator.MultiSlotDataGenerator), {})
        g = gen_cls()
        g.set_batch(3)
        texts[pkg] = g.run_from_memory(lines, out=io.StringIO()).getvalue()
    assert texts["torch"] == texts["jax"]
    n, slots = tnative.parse_multislot(texts["torch"].encode(), 2)
    assert n == 4 and slots[0][1].tolist() == [3, 1, 2, 4]


def _samples(reader, n=6):
    out = []
    for i, s in enumerate(reader()):
        if i == n:
            break
        out.append(s)
    return out


def _same_sample(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_sample(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert np.asarray(b).dtype == np.asarray(a).dtype


READERS = [
    ("mnist", "train", {}), ("mnist", "test", {}), ("cifar", "train10", {}),
    ("cifar", "test100", {}), ("uci_housing", "train", {}), ("imdb", "train", {}),
    ("movielens", "train", {}), ("flowers", "train", {}), ("voc2012", "val", {}),
    ("wmt14", "train", {}), ("wmt16", "validation", {}),
]


@pytest.mark.parametrize("module,split,kw", READERS, ids=["%s.%s" % r[:2] for r in READERS])
def test_synthetic_readers_same_samples(module, split, kw, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DATA_HOME", raising=False)
    j = getattr(getattr(jfluid.dataset, module), split)(**kw)
    t = getattr(getattr(tfluid.dataset, module), split)(**kw)
    js, ts = _samples(j), _samples(t)
    assert len(ts) == len(js) > 0
    for a, b in zip(js, ts):
        _same_sample(a, b)
