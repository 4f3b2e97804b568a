"""The port stands alone: its data files are its own, and no module of it
reads or imports the JAX package.

  * tungsten_tpu_torch/sampling/data/sobol_matrices.npz (the Sobol'
    direction numbers) and tungsten_tpu_torch/models/primitives/data/
    hosek.npz (the Hosek-Wilkie tables and the CIE curves, whose origin and
    licence tungsten_tpu/models/primitives/sky.py states) are byte copies
    of the JAX package's files, and the modules read their own;
  * a scan of every source file of tungsten_tpu_torch/ and of chip_smoke.py
    finds no import of jax or of tungsten_tpu, and no path built from the
    name "tungsten_tpu" (a string literal that is exactly the JAX package's
    directory name).
"""
import ast
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = {"tungsten_tpu_torch/sampling/data/sobol_matrices.npz":
        "tungsten_tpu/sampling/data/sobol_matrices.npz",
        "tungsten_tpu_torch/models/primitives/data/hosek.npz":
        "tungsten_tpu/models/primitives/data/hosek.npz"}


@pytest.mark.parametrize("mine", sorted(DATA))
def test_data_files_are_byte_copies(mine):
    with open(os.path.join(REPO, mine), "rb") as f, open(os.path.join(REPO, DATA[mine]),
                                                           "rb") as g:
        assert f.read() == g.read()


def test_modules_read_their_own_data():
    from tungsten_tpu_torch.models.primitives import sky
    from tungsten_tpu_torch.sampling import sampler

    port = os.path.join(REPO, "tungsten_tpu_torch")
    assert os.path.commonpath([os.path.realpath(sampler._SOBOL_NPZ), port]) == port
    sky._DATA = None
    tables = sky._data()
    assert os.path.commonpath([os.path.realpath(tables.fid.name), port]) == port
    with np.load(os.path.join(REPO, DATA["tungsten_tpu_torch/models/primitives/data/hosek.npz"])
                 ) as theirs:
        assert sorted(tables.files) == sorted(theirs.files)


def _sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO, "tungsten_tpu_torch")):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def _offences(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value.strip("/") == "tungsten_tpu":
                out.append(f"{node.lineno}: the path part {node.value!r}")
            continue
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
        else:
            continue
        out += [f"{node.lineno}: import {n}" for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "flax", "tungsten_tpu")]
    return out


def test_no_source_imports_jax_or_reads_the_jax_package():
    found = {os.path.relpath(p, REPO): o for p in _sources() if (o := _offences(p))}
    assert not found, found
    assert len(list(_sources())) > 50


def test_the_scan_finds_each_kind(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom tungsten_tpu.io import nbt\n"
                   "import os\np = os.path.join('..', 'tungsten_tpu', 'x.npz')\n"
                   "m = __import__('flax')\nfrom . import fine\n")
    found = _offences(str(bad))
    assert len(found) == 4, found
