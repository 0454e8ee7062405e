"""``Executor.train_from_dataset`` of paddle_tpu_torch: the loop, its
prefetch and its trainer descriptors, against a hand loop and against
paddle_tpu.

* DeepFM (8 fields, 200 features, embed 4, deep (16, 16), Adam 1e-3,
  batch 16) from two MultiSlot files through ``InMemoryDataset`` and a
  seeded ``global_shuffle``: the per-step losses are bit-equal to a hand
  loop of ``Executor.run`` over the same batches, with and without
  ``thread=2`` prefetch, and within rtol 1e-5 of the JAX package's
  ``train_from_dataset`` from its saved state (summation order).
* ``thread=2`` under ``CPUPlace`` prefetches on the host (each feed
  reaches ``run`` as a numpy array, never a CUDA tensor); a CUDA
  executor with no card raises at construction, and one whose device is
  CUDA raises in ``train_from_dataset``'s prefetch: there is no host
  fallback.
* The A9 arguments (checkpoints, resume, the phase ledger, the watchdog,
  the step log, a trace id) and a compiled program (A10) raise by name.
* The ``trainer_desc`` checks as the JAX package's: the same errors for
  a Section worker without a ``cut_list`` program and a DownpourSGD one
  without distributed tables, DownpourSGD installs the Communicator,
  the descriptor's fetch list, print period and thread count drive the
  loop; ``infer_from_dataset`` fetches without updating.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.distributed import ps as tps

F, NF, BATCH = 8, 200, 16
PKG = {"jax": (jfluid, jmodels), "torch": (tfluid, tmodels)}


def build(pkg, distributed=False, seed=7, opt=True):
    fluid, models = PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("feat_ids", [F, 1], dtype="int64")
        vals = fluid.layers.data("feat_vals", [F], dtype="float32")
        lbl = fluid.layers.data("label", [1], dtype="int64")
        loss, prob = models.deepfm_ctr(ids, vals, lbl, num_features=NF, num_fields=F,
                                       embed_dim=4, deep_layers=(16, 16),
                                       distributed_emb=distributed)
        if opt:
            fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return main, startup, loss, prob, [ids, vals, lbl]


def _files(tmp_path, n_files=2, lines=48):
    rng = np.random.RandomState(1234)
    paths = []
    for i in range(n_files):
        rows = []
        for _ in range(lines):
            ids = rng.randint(0, NF, F)
            vals = rng.uniform(0, 1, F).round(4)
            rows.append("%d %s %d %s 1 %d" % (F, " ".join(map(str, ids)), F,
                                              " ".join(map(str, vals)), int(ids[0] % 2)))
        p = tmp_path / ("part-%d" % i)
        p.write_text("\n".join(rows) + "\n")
        paths.append(str(p))
    return paths


def _dataset(fluid, use_vars, paths):
    ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_use_var(use_vars)
    ds.set_batch_size(BATCH)
    ds.set_filelist(paths)
    ds.load_into_memory()
    ds.global_shuffle(seed=0)
    return ds


def _jax_state(tmp_path):
    jm, js, *_ = build("jax")
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    d = str(tmp_path / "jax_state")
    with jfluid.scope_guard(scope):
        exe.run(js)
        jfluid.io.save_persistables(exe, d, jm)
    return d


def _port(d):
    main, _, loss, prob, use_vars = build("torch")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_persistables(exe, d, main, scope=scope)
    return main, loss, prob, use_vars, exe, scope


@pytest.mark.parametrize("thread", [0, 2])
def test_losses_bit_equal_to_a_hand_loop(thread, tmp_path):
    d, paths = _jax_state(tmp_path), _files(tmp_path)
    main, loss, _, use_vars, exe, scope = _port(d)
    out = exe.train_from_dataset(main, _dataset(tfluid, use_vars, paths), scope=scope,
                                 thread=thread, fetch_list=[loss])
    main2, loss2, _, use_vars2, exe2, scope2 = _port(d)
    hand = [exe2.run(main2, feed=f, fetch_list=[loss2], scope=scope2)
            for f in _dataset(tfluid, use_vars2, paths)]
    assert len(out) == len(hand) == 2 * 48 // BATCH
    for a, b in zip(out, hand):
        assert a[0].tobytes() == b[0].tobytes()
    for p in main.all_parameters():
        assert np.array_equal(tfluid.scope.to_numpy(scope.get(p.name)),
                              tfluid.scope.to_numpy(scope2.get(p.name))), p.name


def test_losses_match_the_jax_package(tmp_path):
    paths = _files(tmp_path)
    jm, js, jl, _, jvars = build("jax")
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    d = str(tmp_path / "jax_state")
    with jfluid.scope_guard(jscope):
        jexe.run(js)
        jfluid.io.save_persistables(jexe, d, jm)
        jout = jexe.train_from_dataset(jm, _dataset(jfluid, jvars, paths), thread=2,
                                       fetch_list=[jl])
    main, loss, _, use_vars, exe, scope = _port(d)
    tout = exe.train_from_dataset(main, _dataset(tfluid, use_vars, paths), scope=scope,
                                  thread=2, fetch_list=[loss])
    np.testing.assert_allclose([float(o[0]) for o in tout],
                               [float(np.asarray(o[0])) for o in jout], rtol=1e-5)


def test_cpu_prefetch_stays_on_the_host(tmp_path, monkeypatch):
    d, paths = _jax_state(tmp_path), _files(tmp_path)
    main, loss, _, use_vars, exe, scope = _port(d)
    seen = []
    run = exe.run

    def spy(program=None, feed=None, **kw):
        seen.append({k: type(v) for k, v in feed.items()})
        return run(program, feed=feed, **kw)

    monkeypatch.setattr(exe, "run", spy)
    exe.train_from_dataset(main, _dataset(tfluid, use_vars, paths), scope=scope, thread=2,
                           fetch_list=[loss])
    assert len(seen) == 6 and all(t is np.ndarray for s in seen for t in s.values())


def test_cuda_executor_without_a_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tfluid.Executor(tfluid.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tfluid.Executor()
    # an executor whose device is a card: its prefetch stages there, and
    # raises rather than prefetching on the host
    d, paths = _jax_state(tmp_path), _files(tmp_path)
    main, loss, _, use_vars, exe, scope = _port(d)
    exe.device = torch.device("cuda:0")
    ran = []
    monkeypatch.setattr(exe, "run", lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        exe.train_from_dataset(main, _dataset(tfluid, use_vars, paths), scope=scope, thread=2,
                               fetch_list=[loss])
    assert ran == []


@pytest.mark.parametrize("arg", [dict(checkpoint_dir="ckpt"), dict(resume_from="ckpt"),
                                 dict(phase_ledger=True), dict(watchdog=True),
                                 dict(train_log="log.jsonl"), dict(trace_id="abc")],
                         ids=lambda a: next(iter(a)))
def test_a9_arguments_raise_by_name(arg, tmp_path):
    main, _, loss, _, use_vars = build("torch")
    exe = tfluid.Executor(tfluid.CPUPlace())
    name = next(iter(arg))
    with pytest.raises(NotImplementedError, match=r"%s.*A9" % name):
        exe.train_from_dataset(main, [], fetch_list=[loss], **arg)


def test_compiled_program_raises_a10():
    class Compiled:
        _is_compiled_program = True

    with pytest.raises(NotImplementedError, match="A10"):
        tfluid.Executor(tfluid.CPUPlace()).train_from_dataset(Compiled(), [])


def _errors(kind, distributed_tables):
    """The error each package raises for a trainer of ``kind`` on a
    DeepFM program with or without distributed tables."""
    out = {}
    for pkg, (fluid, _) in PKG.items():
        main, startup, loss, _, _ = build(pkg, distributed=distributed_tables)
        trainer = fluid.trainer_desc.TrainerFactory().create_trainer(
            {"device_worker": kind, "trainer": "DistMultiTrainer"})
        exe = fluid.Executor(fluid.CPUPlace())
        with pytest.raises(ValueError) as e:
            exe.train_from_dataset(main, [], trainer_desc=trainer, fetch_list=[loss])
        out[pkg] = str(e.value)
    return out


@pytest.mark.parametrize("kind,dist", [("Section", False), ("Section", True),
                                       ("DownpourSGD", False)])
def test_trainer_desc_refusals_as_the_jax_package(kind, dist):
    errs = _errors(kind, dist)
    assert errs["torch"] == errs["jax"]
    assert ("cut_list" if kind == "Section" else "is_distributed") in errs["torch"]


def test_trainer_factory_and_descriptors():
    td = tfluid.trainer_desc
    for opt, cls, worker in ((None, td.MultiTrainer, td.Hogwild),
                             ({"trainer": "DistMultiTrainer", "device_worker": "DownpourSGD"},
                              td.DistMultiTrainer, td.DownpourSGD),
                             ({"trainer": "PipelineTrainer", "device_worker": "Section",
                               "num_microbatches": 4}, td.PipelineTrainer, td.Section)):
        t = tfluid.TrainerFactory().create_trainer(opt)
        assert type(t) is cls and type(t._worker) is worker
    assert t._worker.num_microbatches == 4
    assert sorted(td.__all__) == sorted(jfluid.trainer_desc.__all__)


def test_downpour_installs_the_communicator_and_trains(tmp_path):
    d, paths = None, _files(tmp_path)
    server = tps.ParameterServer().start()
    try:
        main, startup, loss, _, use_vars = build("torch", distributed=True)
        tfluid.distributed.bind_distributed_tables(main, [server.endpoint], lr=0.05)
        trainer = tfluid.TrainerFactory().create_trainer(
            {"trainer": "DistMultiTrainer", "device_worker": "DownpourSGD"})
        trainer.set_fetch_var_and_info([loss], ["loss"], 2)
        trainer.set_thread(2)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        assert getattr(main, "_ps_communicator", None) is None
        ds = _dataset(tfluid, use_vars, paths)
        out = exe.train_from_dataset(main, ds, scope=scope, trainer_desc=trainer)
        comm = main._ps_communicator
        assert comm is not None and len(out) == 6
        comm.flush()
        assert comm.pending() == 0
        stats = exe.jit_cache_stats()
        assert stats["ps_pull_overlap_s"] + stats["ps_pull_wait_s"] > 0
        comm.stop()
    finally:
        server.stop()


def test_debug_prints_each_print_period(tmp_path, capsys):
    d, paths = _jax_state(tmp_path), _files(tmp_path)
    main, loss, _, use_vars, exe, scope = _port(d)
    exe.train_from_dataset(main, _dataset(tfluid, use_vars, paths), scope=scope, debug=True,
                           fetch_list=[loss], fetch_info=["loss"], print_period=2)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("batch ")]
    assert [ln.split(":")[0] for ln in lines] == ["batch 0", "batch 2", "batch 4"]
    assert "'loss'" in lines[0]


def test_infer_from_dataset_fetches_without_updating(tmp_path):
    d, paths = _jax_state(tmp_path), _files(tmp_path)
    main, loss, prob, use_vars, exe, scope = _port(d)
    test_prog = main.clone(for_test=True)
    before = {p.name: tfluid.scope.to_numpy(scope.get(p.name)).copy()
              for p in main.all_parameters()}
    out = exe.infer_from_dataset(test_prog, _dataset(tfluid, use_vars, paths), scope=scope,
                                 fetch_list=[prob])
    assert len(out) == 6 and out[0][0].shape == (BATCH, 1)
    assert ((out[0][0] > 0) & (out[0][0] < 1)).all()
    for n, v in before.items():
        assert np.array_equal(tfluid.scope.to_numpy(scope.get(n)), v), n
