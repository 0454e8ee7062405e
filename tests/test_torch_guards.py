"""The port's guards (``python -m paddle_tpu_torch.tools.<name>``): each
runs green on the port's tree, and each fails on a doctored copy under
``tmp_path`` — an undocumented or untested fault point, an undocumented
or stale metric row, a flipped checkpoint byte, a blocking call in a
hot-path region."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.faults.checkpoint import TrainCheckpoint
from paddle_tpu_torch.tools import (check_checkpoint, check_fault_points, check_hot_path,
                                    check_metrics_docs, readme_subsection)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_POINTS = {"executor.run", "reader.prefetch", "ps.pull", "ps.push", "checkpoint.commit",
               "checkpoint.restore", "decode.step", "decode.prefix_admit", "server.admit",
               "replica.dispatch", "wire.send", "fleet.dispatch"}


def test_fault_points_documented_and_tested():
    assert check_fault_points.check(REPO_ROOT) == []
    assert set(check_fault_points.source_points(REPO_ROOT)) == PORT_POINTS


def test_metrics_documented():
    undocumented, stale = check_metrics_docs.check(REPO_ROOT)
    assert not undocumented and not stale, (undocumented, stale)
    assert "executor_runs_total" in check_metrics_docs.documented_metrics(REPO_ROOT)
    assert len(check_metrics_docs.registered_metrics()) >= 30


def test_hot_paths_clean_and_present():
    assert check_hot_path.check_files(REPO_ROOT) == []
    for rel in check_hot_path.CHECKED_FILES:
        with open(os.path.join(REPO_ROOT, rel)) as f:
            assert check_hot_path._BEGIN.search(f.read()), rel


def _mini_tree(root, readme_rows, source, test_text=""):
    (root / "paddle_tpu_torch").mkdir()
    (root / "paddle_tpu_torch" / "x.py").write_text(source)
    (root / "tests").mkdir()
    (root / "tests" / "test_torch_x.py").write_text(test_text)
    (root / "README.md").write_text(
        "# top\n\n## PyTorch/CUDA port: `paddle_tpu_torch/`\n\n### Fault tolerance\n\n"
        + readme_rows + "\n### Observability\n\n| `reqs_total` | counter | x |\n"
        "\n## Other section\n\n| `outside.point` | not the port's |\n")


@pytest.mark.parametrize("case", ["undocumented", "stale", "untested", "two_modules"])
def test_fault_point_guard_catches_drift(tmp_path, case):
    src = 'if a is not None:\n    a.faultpoint("ghost.point")\n'
    rows = {"undocumented": "| `other.point` | x | y |\n", "stale": "| `ghost.point` | x |\n"
            "| `gone.point` | x |\n", "untested": "| `ghost.point` | x |\n",
            "two_modules": "| `ghost.point` | x |\n"}[case]
    tests = "" if case == "untested" else "arm('ghost.point=error')"
    _mini_tree(tmp_path, rows, src, tests)
    if case == "two_modules":
        (tmp_path / "paddle_tpu_torch" / "y.py").write_text(src)
    problems = check_fault_points.check(str(tmp_path))
    want = {"undocumented": "not in the README", "stale": "stale README catalog row 'gone.point'",
            "untested": "no port test", "two_modules": "multiple modules"}[case]
    assert any(want in p for p in problems), problems
    assert "outside.point" not in check_fault_points.documented_points(str(tmp_path))


def test_metrics_guard_catches_an_undocumented_and_a_stale_row(tmp_path):
    readme = open(os.path.join(REPO_ROOT, "README.md")).read()
    doctored = readme.replace("| `executor_runs_total` |", "| `executor_runs_totally` |", 1)
    assert doctored != readme
    (tmp_path / "README.md").write_text(doctored)
    undocumented, stale = check_metrics_docs.check(str(tmp_path))
    assert undocumented == {"executor_runs_total"} and stale == {"executor_runs_totally"}


def test_readme_subsection_reads_only_the_port_section(tmp_path):
    _mini_tree(tmp_path, "| `a.b` | x |\n", "")
    lines = readme_subsection(str(tmp_path), "Observability")
    assert any("reqs_total" in ln for ln in lines)
    assert not any("outside.point" in ln for ln in lines)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 1))
        tfluid.optimizer.AdamOptimizer(0.1).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path_factory.mktemp("guard_ckpt") / "run")
    feeds = [{"x": np.ones((2, 4), "float32")}] * 4
    exe.train_from_dataset(main, feeds, scope=scope, fetch_list=[loss], checkpoint_dir=d,
                           checkpoint_every=2)
    return d


def _copy(run_dir, tmp_path):
    dst = str(tmp_path / "run")
    shutil.copytree(run_dir, dst)
    return dst


def test_checkpoint_verifier_green(run_dir):
    assert check_checkpoint.check(run_dir) == []
    assert check_checkpoint.check(run_dir, checkpoint="ckpt-000004") == []


@pytest.mark.parametrize("damage", ["flip_param", "drop_param", "dangling_latest", "bad_cursor",
                                    "no_integrity", "shards"])
def test_checkpoint_verifier_flags_damage(run_dir, tmp_path, damage):
    d = _copy(run_dir, tmp_path)
    ck = os.path.join(d, "ckpt-000004")
    params = os.path.join(ck, "params")
    npy = os.path.join(params, sorted(f for f in os.listdir(params) if f.endswith(".npy"))[0])
    if damage == "flip_param":
        with open(npy, "r+b") as f:
            f.seek(-1, 2)
            b = f.read(1)
            f.seek(-1, 2)
            f.write(bytes([b[0] ^ 0xFF]))
    elif damage == "drop_param":
        os.remove(npy)
    elif damage == "dangling_latest":
        open(os.path.join(d, "LATEST"), "w").write("ckpt-000099\n")
    elif damage == "bad_cursor":
        open(os.path.join(ck, "cursor.json"), "w").write("{}")
    elif damage == "no_integrity":
        os.remove(os.path.join(ck, "integrity.json"))
    else:
        os.makedirs(os.path.join(ck, "shards"))
    problems = check_checkpoint.check(d)
    want = {"flip_param": "content hash", "drop_param": "has no file",
            "dangling_latest": "LATEST points", "bad_cursor": "cursor.json",
            "no_integrity": "no integrity.json", "shards": "shards/ has no manifest.json"}[damage]
    assert any(want in p for p in problems), problems


def test_checkpoint_verifier_cli_exit_codes(run_dir, tmp_path):
    def cli(path):
        return subprocess.run([sys.executable, "-m", "paddle_tpu_torch.tools.check_checkpoint",
                               path], cwd=REPO_ROOT, capture_output=True, text=True).returncode

    d = _copy(run_dir, tmp_path)
    assert cli(d) == 0
    os.remove(os.path.join(d, "ckpt-000004", "cursor.json"))
    assert cli(d) == 1


@pytest.mark.parametrize("token", ["x.item()", "t.cpu()", "t.tolist()",
                                   "torch.cuda.synchronize()", "np.asarray(t)"])
def test_hot_path_guard_catches_blocking_calls(token):
    src = "a = 1\n# hot-path: begin step\ny = %s\n# hot-path: end step\n" % token
    assert [v[2] for v in check_hot_path.check_source(src)] != []
    waived = src.replace(token, token + "  # hot-ok: a host value")
    assert check_hot_path.check_source(waived) == []


def test_hot_path_guard_flags_structure():
    assert check_hot_path.check_source("# hot-path: begin a\nx = 1\n")[0][2] == "<unclosed>"
    assert check_hot_path.check_source("# hot-path: end a\n")[0][2] == "<orphan-end>"
    nested = "# hot-path: begin a\n# hot-path: begin b\n# hot-path: end b\n"
    assert check_hot_path.check_source(nested)[0][2] == "<nesting>"
