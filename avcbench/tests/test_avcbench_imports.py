"""Nothing the harness runs on the chip imports JAX or the JAX package:
the import statements of every module, test and tool under ``avcbench/``,
and the modules a whole run has loaded.
Top-level names are compared whole, since the program's name begins with
the JAX package's."""
import ast
import json
import subprocess
import sys

from conftest import ROOT

from avcbench.run import FORBIDDEN, loaded_forbidden

HARNESS = ROOT / "avcbench"


def files():
    return list(HARNESS.rglob("*.py"))


def imported(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_forbidden_import_statement():
    found = {str(p.relative_to(ROOT)): imported(p) & set(FORBIDDEN)
             for p in files()}
    assert len(found) > 15
    assert any("tools" in k for k in found)
    assert not {k: v for k, v in found.items() if v}


def test_reads_nothing_of_the_old_benchmark():
    for p in files():
        if "tests" in p.relative_to(HARNESS).parts:
            continue
        src = p.read_text()
        for banned in ("benchdata", "dryv_tpu_torch.bench",
                       "dryv_tpu_torch/bench", '"bench.py"'):
            assert banned not in src, (p, banned)


def test_names_are_compared_whole():
    code = ("import sys; sys.path.insert(0, %r); import dryv_tpu_torch; "
            "from avcbench.run import loaded_forbidden as f; a = f(); "
            "import dryv_tpu; print(a, f())" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.stdout.split("\n")[0].strip() == "[] ['dryv_tpu']", r.stderr


def test_a_whole_run_loads_no_forbidden_module():
    code = """
import json, sys
from pathlib import Path
sys.path.insert(0, %r)
from avcbench.run import loaded_forbidden, measure
root = Path(%r)
folder = root / "avcbench" / "tests" / "configs" / "tiny-intra"
cfg = json.loads((folder / "config.json").read_text())
mix = {"entry": "intra_batched", "request": "idr_stream", "pictures": 16,
       "loop": "closed", "clients": 1, "output": "device", "n_threads": 2,
       "batch": 16, "distinct": 1, "check_every": 1}
run, numbers = measure(folder, cfg, mix, 3, 0.1, True, "cpu")
print(json.dumps([numbers, loaded_forbidden()]))
""" % (str(ROOT), str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900)
    numbers, bad = json.loads(r.stdout.strip().splitlines()[-1])
    assert numbers == {"pictures_wrong": 0, "requests_failed": 0}
    assert bad == [] and "jax" not in r.stderr


def test_loaded_forbidden_in_this_process_is_a_list():
    assert isinstance(loaded_forbidden(), list)
