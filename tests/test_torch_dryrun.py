"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's choices and a hand count, run in a subprocess: the dry run joins
a fake default process group, which a test process must not hold.

The subprocess (one for the file) runs, on fake groups of 4 and 256
ranks: the count of ``all_reduce`` / ``all_gather`` / ``reduce_scatter``
on ``meta`` tensors; ``lower_train_cell``, ``lower_prefill_cell`` and
``lower_decode_cell`` for a reduced config of each family (dense, MoE,
SSM, hybrid, encoder-decoder) on a (data=2, model=2) mesh, the decode
both batch- and sequence-sharded; ``run_cell`` for qwen2.5-3b
``train_4k`` on the (16, 16) mesh; and the refusal to run over a group
it did not make.  The parent holds rank 0's argument bytes to a count
from ``param_pspecs`` and the optimizer choice to the JAX package's
``pick_optimizer`` on both production meshes.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro.models.layers import split_tree  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.models.config import compute_dims as tcompute_dims  # noqa: E402
from repro_torch.sketchstream.monitor import SketchMonitorConfig  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen2.5-3b", "deepseek-moe-16b", "mamba2-370m", "jamba-1.5-large-398b",
            "seamless-m4t-large-v2")
# (kind, seq, batch) of the reduced cells on (data=2, model=2); the last is
# a decode of one row, whose cache splits its sequence over the data axis
CELLS = (("train", 32, 4), ("prefill", 32, 4), ("decode", 32, 4), ("decode", 32, 1))

SCRIPT = r'''
import json, sys
import torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.launch import dryrun, roofline as RL
from repro_torch.launch.mesh import AbstractMesh, make_debug_mesh
out = {}
dryrun.init_fake_world(4)
group = dist.new_group([0, 1, 2, 3])
x = torch.empty((8, 16), dtype=torch.float32, device="meta")
with RL.count_cost() as c:
    dist.all_reduce(x, group=group)
    dist.all_gather_into_tensor(torch.empty((32, 16), device="meta"), x, group=group)
    dist.reduce_scatter_tensor(torch.empty((2, 16), device="meta"), x, group=group)
out["collectives"] = RL.parse_collectives(c.cost)
mesh = make_debug_mesh(2, 2, device_type="cpu")
cells = {}
for arch in FAMILIES:
    cfg = configs.reduced(arch)
    for kind, seq, batch in CELLS:
        shape = configs.ShapeSpec("t", kind, seq, batch)
        fn = {"train": dryrun.lower_train_cell, "prefill": dryrun.lower_prefill_cell,
              "decode": dryrun.lower_decode_cell}[kind]
        cost, meta = fn(cfg, mesh, shape)
        cells[f"{arch}/{kind}/{batch}"] = {"memory": cost.memory(), "flops": cost.flops,
                                           "wire": cost.total_wire_bytes, **meta}
out["cells"] = cells
rep = dryrun.run_cell("qwen2.5-3b", "train_4k")
out["qwen"] = {"memory": rep["memory"], "roofline": rep["roofline"],
               "optimizer": rep["optimizer"], "chips": rep["chips"], "mesh": rep["mesh"],
               "expected": dryrun.expected_argument_bytes("qwen2.5-3b", "train_4k")}
out["picks"] = {}
for multi_pod in (False, True):
    mesh_ = AbstractMesh(*(((2, 16, 16), ("pod", "data", "model")) if multi_pod
                           else ((16, 16), ("data", "model"))))
    for arch in configs.ARCH_NAMES:
        out["picks"][f"{arch}/{multi_pod}"] = dryrun.pick_optimizer(
            configs.get(arch), mesh_, None)[1]
dist.destroy_process_group()
dryrun._FAKE_WORLD.clear()
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
try:
    dryrun.init_fake_world(256)
    out["refused"] = False
except RuntimeError:
    out["refused"] = True
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def sub():
    code = f"FAMILIES = {FAMILIES!r}\nCELLS = {CELLS!r}\n" + SCRIPT
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600, cwd=ROOT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(lines[-1][len("RESULT "):])


def test_collectives_are_counted_by_the_wire_rule(sub):
    col = sub["collectives"]
    assert col["all-reduce"] == {"count": 1, "bytes": 512, "wire_bytes": 1024}
    assert col["all-gather"] == {"count": 1, "bytes": 2048, "wire_bytes": 2048}
    assert col["reduce-scatter"] == {"count": 1, "bytes": 128, "wire_bytes": 128}
    assert col["total_wire_bytes"] == 1024 + 2048 + 128


def _hand_count(arch, kind, seq, batch) -> int:
    """Rank 0's argument bytes on (data=2, model=2) from ``param_pspecs``:
    each leaf's elements over the sizes of the mesh axes its spec splits."""
    mesh = AbstractMesh((2, 2), ("data", "model"))
    cfg = tconfigs.reduced(arch)
    dims = tcompute_dims(cfg, tp=2)
    params = tM.init_params(torch.Generator(), cfg, dims, device="meta")
    leaves, _ = tree_flatten(params)
    specs = tree_flatten(SH.param_pspecs(mesh, tM.param_axes(params)), is_leaf=SH.is_pspec)[0]
    sizes = {"data": 2, "model": 2}
    blocks = [x.numel() // math.prod(sizes[a] for e in spec for a in SH._mesh_axes(e))
              for x, spec in zip(leaves, specs)]
    src = max(seq // 4, 16)
    if kind == "train":
        rows = batch // 2
        mon = SketchMonitorConfig()
        levels = mon.d - mon.s + 1
        monitor = levels * mon.depth * mon.width * 4 + 4 + 4     # its block, n, step
        enc = rows * src * cfg.d_model * 2 if cfg.is_encdec else 0
        # p, m, v in f32, the state's step; the optimizer's step is a host scalar
        return 3 * 4 * sum(blocks) + monitor + 4 + 2 * rows * seq * 4 + enc
    params_bytes = 2 * sum(blocks)
    if kind == "prefill":
        return params_bytes + batch * seq * 4 + (batch * src * cfg.d_model * 2
                                                 if cfg.is_encdec else 0)
    return None


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_cells_of_every_family_run_on_a_2x2_mesh(sub, arch):
    for kind, seq, batch in CELLS:
        cell = sub["cells"][f"{arch}/{kind}/{batch}"]
        mem = cell["memory"]
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert cell["flops"] > 0
        want = _hand_count(arch, kind, seq, batch)
        if want is not None:
            assert mem["argument_bytes"] == want, (kind, mem, want)
        if kind == "decode":
            assert cell["cache_layout"] == ("seq" if batch < 2 else "batch")
        if kind == "train":
            assert cell["optimizer"] == "adamw"


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_argument_bytes_equal_the_local_blocks(sub, arch):
    """The decode cells' arguments: the parameters' and the cache's
    ``local_block`` sizes under ``cache_shardings`` (either regime)."""
    from repro_torch.launch import serve as SV
    mesh = AbstractMesh((2, 2), ("data", "model"))
    cfg = tconfigs.reduced(arch)
    dims = tcompute_dims(cfg, tp=2)
    params = tM.init_params(torch.Generator(), cfg, dims, device="meta")
    pbytes = dryrun._blocks_bytes(params, SH.param_shardings(mesh, tM.param_axes(params))) // 2
    for kind, seq, batch in CELLS:
        if kind != "decode":
            continue
        src = max(seq // 4, 16) if cfg.is_encdec else 0
        cache, shard = SV.cache_shardings(mesh, cfg, dims, batch, seq, src)
        want = pbytes + dryrun._blocks_bytes(cache, shard) + batch * 4
        assert sub["cells"][f"{arch}/{kind}/{batch}"]["memory"]["argument_bytes"] == want


def test_qwen_train_4k_on_the_256_rank_mesh(sub):
    q = sub["qwen"]
    assert q["chips"] == 256 and q["mesh"] == {"data": 16, "model": 16}
    assert q["optimizer"] == "adamw"
    assert q["memory"]["argument_bytes"] == q["expected"] == 159_561_740
    rl = q["roofline"]
    assert rl["flops"] > rl["model_flops"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert rl["wire_bytes"] > 0


def _jax_pick(arch, multi_pod):
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun      # sets XLA_FLAGS on import
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else ((16, 16),
                                                                            ("data", "model"))
    mesh = JAbstractMesh(shape, names)
    cfg = jconfigs.get(arch)
    dims = jcompute_dims(cfg, tp=16)
    abstract = jax.eval_shape(lambda: jM.init_params(jax.random.PRNGKey(0), cfg, dims))
    _, axes = split_tree(abstract)
    return jdryrun.pick_optimizer(cfg, mesh, JSH.param_pspecs(mesh, axes))[1]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_pick_optimizer_equals_the_reference(sub, multi_pod):
    for arch in tconfigs.ARCH_NAMES:
        assert sub["picks"][f"{arch}/{multi_pod}"] == _jax_pick(arch, multi_pod), arch


def test_refuses_a_group_it_did_not_make(sub):
    assert sub["refused"] is True
