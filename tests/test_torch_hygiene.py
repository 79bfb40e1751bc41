"""Hygiene of the PyTorch port: it never imports JAX, Flax or the JAX
package; its entry points refuse to fall back to the CPU; a tensor that is
not on the CPU never reaches a plain version; the Python mirror of the
kernels' packed model table matches the C struct."""

import ast
import inspect
import os
import re
import subprocess
import sys

import pytest
import torch

import robosuite_tpu_torch
from robosuite_tpu_torch.ops import build, contact_solve, fk, forward, substep, tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "robosuite_tpu_torch")
FORBIDDEN = ("jax", "flax", "robosuite_tpu")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path} imports {n}"


def test_package_imports_with_jax_blocked():
    """Import every module of the port (and chip_smoke) in a fresh process
    in which importing jax, flax or robosuite_tpu raises."""
    code = r"""
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "flax", "robosuite_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import robosuite_tpu_torch
for m in pkgutil.walk_packages(robosuite_tpu_torch.__path__, "robosuite_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
assert not any(k.split(".")[0] in ("jax", "flax", "robosuite_tpu") for k in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


def test_make_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        robosuite_tpu_torch.make("Lift", robots="Panda", reward_shaping=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build.library.__wrapped__()


class _FakeLib:
    """Stands in for the kernel library; any launch is recorded."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return 0
        return launch


def test_non_cpu_tensors_never_reach_a_plain_version(monkeypatch):
    """On a non-CPU tensor each wrapper launches its kernel or raises; the
    plain versions are never called (meta tensors stand in for CUDA ones:
    the operand check rejects them, so the wrappers raise)."""
    def forbidden(*a, **k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    monkeypatch.setattr(forward, "forward_plain", forbidden)
    monkeypatch.setattr(contact_solve, "vel_update_plain", forbidden)
    monkeypatch.setattr(substep, "substep_plain", forbidden)
    monkeypatch.setattr(substep, "substep_aux_plain", forbidden)
    monkeypatch.setattr(fk, "fk_pose_plain", forbidden)
    monkeypatch.setattr(build, "library", lambda: _FakeLib())
    env = robosuite_tpu_torch.make("Lift", robots="Panda", device="cpu")
    m = env.model
    B, meta = 2, torch.device("meta")
    q = torch.empty(B, m.nq, device=meta)
    qd = torch.empty(B, m.nv, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        forward.forward_products(m, q, qd, torch.empty(B, m.nbody, device=meta),
                                 torch.empty(B, m.nbody, 3, device=meta), torch.empty(B, 3, device=meta),
                                 torch.empty(B, m.nv, device=meta))
    K = 66
    with pytest.raises(ValueError, match="CUDA"):
        contact_solve.vel_update(torch.empty(B, m.nv, m.nv, device=meta), torch.empty(B, m.nv, 3 * K, device=meta),
                                 torch.empty(B, 3 * K, device=meta), qd, qd, qd, torch.empty(B, 3 * K, device=meta),
                                 torch.empty(B, K, device=meta), torch.empty(B, K, device=meta), 30, 8, 0.002)
    for emit_aux in (False, True):
        fused = substep.make_fused_substep(env, m, emit_aux=emit_aux)
        with pytest.raises(ValueError, match="CUDA"):
            fused(q, qd, torch.empty(B, m.nbody, device=meta), torch.empty(B, m.nbody, 3, device=meta),
                  torch.empty(B, 3, device=meta), torch.empty(B, m.nv, device=meta),
                  torch.empty(B, 12, device=meta), torch.empty(B, 12, device=meta), torch.empty(B, 2, device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        fk.fk_pose(m, q)
    # the JOINT_POSITION branch (Stack): goal (B, na), gains (B, 2 na)
    env = robosuite_tpu_torch.make("Stack", robots="Panda", controller_configs="JOINT_POSITION", device="cpu")
    m = env.model
    for emit_aux in (False, True):
        fused = substep.make_fused_substep(env, m, emit_aux=emit_aux)
        with pytest.raises(ValueError, match="CUDA"):
            fused(torch.empty(B, m.nq, device=meta), torch.empty(B, m.nv, device=meta),
                  torch.empty(B, m.nbody, device=meta), torch.empty(B, m.nbody, 3, device=meta),
                  torch.empty(B, 3, device=meta), torch.empty(B, m.nv, device=meta),
                  torch.empty(B, 7, device=meta), torch.empty(B, 14, device=meta), torch.empty(B, 2, device=meta))


@pytest.mark.parametrize("fn", [forward.forward_products, contact_solve.vel_update, substep.make_fused_substep,
                                fk.fk_pose], ids=["forward", "contact_solve", "substep", "fk"])
def test_wrappers_have_no_fallback(fn):
    """No try/except in a wrapper: a kernel that fails raises."""
    src = inspect.getsource(fn)
    assert "except" not in src and "try:" not in src


def test_table_mirror_matches_c_struct():
    """ops/tables.RsTables declares the fields of csrc/common.cuh's
    RsTables in the same order with the same shapes."""
    with open(os.path.join(PKG, "csrc", "common.cuh")) as f:
        src = f.read()
    body = src[src.index("struct RsTables {") + len("struct RsTables {"): src.index("};", src.index("struct RsTables {"))]
    consts = dict(re.findall(r"#define (RS_\w+) (\d+)", src))
    c_fields = []
    for decl in body.split(";"):
        decl = re.sub(r"//[^\n]*", "", decl).strip()
        if not decl:
            continue
        ctype, rest = decl.split(None, 1)
        for item in rest.split(","):
            item = item.strip()
            name = item.split("[")[0]
            dims = [int(consts.get(d, d)) for d in re.findall(r"\[(\w+)\]", item)]
            c_fields.append((name, ctype, dims))
    py_fields = []
    for name, ctype in tables.RsTables._fields_:
        dims = []
        while hasattr(ctype, "_length_"):
            dims.append(ctype._length_)
            ctype = ctype._type_
        kind = {"c_int": "int", "c_float": "float", "c_uint": "uint32_t"}[ctype.__name__]
        py_fields.append((name, kind, dims))
    assert c_fields == py_fields
