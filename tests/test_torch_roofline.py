"""The port's roofline count (``repro_torch.launch.roofline``) and kernel
work formulas (``repro_torch.kernels.work``) against the JAX package.

``count_cost`` counts a step's FLOPs from its eager products; the JAX
package's ``hlo_cost`` from the ``dot`` instructions of XLA's compiled
HLO.  Here both count the same functions of the reduced configs at (2, 64)
tokens and must agree exactly: forward for all ten configs, and the
gradient of reduced qwen2.5-3b with remat none and full.  The port's
mamba forward used to count 1,048,576 FLOPs more than XLA's (24,903,680
against 23,855,104; jamba 7,340,032): ``ssd_chunked`` ran the last chunk's
state update, whose result a training forward discards and XLA drops as
dead code; it now skips it (``final_state=False``).  The rest holds the
count's bytes, its kernel-op costs, ``Roofline`` and the formulas at the
shapes of the kernel table in PERF.md.  A subprocess imports the two new
modules and finds no ``jax`` or ``repro`` module.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import projections as proj  # noqa: E402
from repro_torch.kernels import ops, work  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.config import compute_dims as tcompute_dims  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(tconfigs.ARCH_NAMES)
B, S, SRC = 2, 64, 16


def _jax_abstract(arch):
    cfg = jconfigs.reduced(arch)
    dims = jcompute_dims(cfg, tp=1)
    params = jax.eval_shape(lambda: jM.strip_p(jM.init_params(jax.random.PRNGKey(0), cfg, dims)))
    return cfg, dims, params


def _jax_flops(fn, *args) -> int:
    return int(JRL.hlo_cost(jax.jit(fn).lower(*args).compile().as_text())["flops"])


def _port_meta(arch):
    cfg = tconfigs.reduced(arch)
    dims = tcompute_dims(cfg, tp=1)
    return cfg, dims, tM.init_params(torch.Generator(), cfg, dims, device="meta")


def _enc(cfg, device="meta"):
    return (torch.empty((B, SRC, cfg.d_model), dtype=torch.float32, device=device)
            if cfg.is_encdec else None)


@functools.lru_cache(maxsize=None)
def _jax_forward_flops(arch) -> int:
    cfg, dims, params = _jax_abstract(arch)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if cfg.is_encdec:
        ef = jax.ShapeDtypeStruct((B, SRC, cfg.d_model), jnp.float32)
        return _jax_flops(lambda p, t, e: jM.forward(p, cfg, dims, t, enc_feats=e),
                          params, tok, ef)
    return _jax_flops(lambda p, t: jM.forward(p, cfg, dims, t), params, tok)


def _port_forward_cost(arch, device="meta"):
    cfg, dims, params = _port_meta(arch)
    if device != "meta":
        params = tM.init_params(torch.Generator().manual_seed(0), cfg, dims, device=device)
    tok = torch.zeros((B, S), dtype=torch.int32, device=device)
    with RL.count_cost() as counter:
        tM.forward(params, cfg, dims, tok, enc_feats=_enc(cfg, device))
    return counter.cost


# ---------------------------------------------------------------------------
# FLOPs against XLA's dot count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    for tokens in (1, 4096, 256 * 4096):
        for train in (True, False):
            assert RL.model_flops(cfg, tokens, train=train) == JRL.model_flops(
                jcfg, tokens, train=train)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_equal_xla_dots(arch):
    assert _port_forward_cost(arch).flops == _jax_forward_flops(arch)


def test_forward_flops_of_the_stated_configs():
    """The counts this module's docstring states."""
    want = {"qwen2.5-3b": 26_214_400, "deepseek-moe-16b": 198_836_224,
            "mamba2-370m": 23_855_104, "jamba-1.5-large-398b": 1_621_884_928}
    for arch, flops in want.items():
        assert _port_forward_cost(arch).flops == flops, arch


@pytest.mark.parametrize("remat,want", [("none", 78_643_200), ("full", 96_468_992)])
def test_gradient_flops_equal_xla_dots(remat, want):
    jcfg, jdims, jparams = _jax_abstract("qwen2.5-3b")
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)

    def jloss(p, t):
        lg, _ = jM.forward(p, jcfg, jdims, t, remat=remat)
        return jM.lm_loss(lg, t, jcfg.vocab_size)
    assert _jax_flops(jax.grad(jloss), jparams, tok) == want

    cfg, dims, params = _port_meta("qwen2.5-3b")
    leaves, treedef = tree_flatten(params)
    leaves = [x.requires_grad_(True) for x in leaves]
    t = torch.zeros((B, S), dtype=torch.int32, device="meta")
    with RL.count_cost() as counter:
        lg, _ = tM.forward(treedef.unflatten(leaves), cfg, dims, t, remat=remat)
        torch.autograd.grad(tM.lm_loss(lg, t, cfg.vocab_size), leaves)
    assert counter.cost.flops == want


def test_ssd_skips_only_the_discarded_final_state():
    """``final_state=False`` drops the last chunk's state product (2 B H N P L
    flops) and nothing the output reads; prefill still returns the state."""
    rng = np.random.default_rng(0)
    b, s, h, p, g, n, chunk = 2, 32, 4, 8, 1, 16, 16
    x, bm, cm = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
    dt = torch.from_numpy(rng.uniform(0.1, 1, size=(b, s, h)).astype(np.float32))
    a = -dt
    with RL.count_cost() as full:
        y, state = tssm.ssd_chunked(x, a, dt, bm, cm, chunk=chunk)
    with RL.count_cost() as skip:
        y2, none = tssm.ssd_chunked(x, a, dt, bm, cm, chunk=chunk, final_state=False)
    assert none is None and state.shape == (b, h, n, p)
    assert torch.equal(y, y2)
    assert full.cost.flops - skip.cost.flops == 2 * b * h * n * p * chunk


# ---------------------------------------------------------------------------
# bytes, kernel ops, memory
# ---------------------------------------------------------------------------

def test_matmul_and_expanded_operand_bytes():
    a = torch.ones((8, 16), dtype=torch.float32)
    w = torch.ones((16, 4), dtype=torch.bfloat16)
    with RL.count_cost() as counter:
        torch.mm(a, a.T)                          # reads a twice, writes 8 x 8
    cost = counter.cost
    assert cost.flops_by_dtype == {"float32": 2 * 8 * 8 * 16}
    assert cost.hbm_bytes == 2 * 8 * 16 * 4 + 8 * 8 * 4
    report = cost.as_dict()          # the reference's hlo_cost keys, and the port's
    assert set(report) == {"flops", "flops_by_dtype", "hbm_bytes", "collectives",
                           "total_wire_bytes", "kernel_ops", "memory"}
    assert report["flops"] == 2 * 8 * 8 * 16 and report["total_wire_bytes"] == 0
    kv = torch.ones((2, 5, 1, 3))                  # one KV head read by four query heads
    with RL.count_cost() as counter:
        kv.expand(2, 5, 4, 3).sum()
        w.to(torch.float32)
    # the expanded view reads its 30 elements once, not four times; the
    # view itself moves nothing
    assert counter.cost.hbm_bytes == 30 * 4 + 4 + 64 * 2 + 64 * 4
    assert counter.cost.hbm_by_op == {"aten::sum": 30 * 4 + 4, "aten::_to_copy": 64 * 6}
    assert RL.touched_bytes(kv.expand(2, 5, 4, 3)) == 120
    assert RL.touched_bytes(torch.ones(10, 10)[:, :2]) == 20 * 4     # its elements, not its span


def test_host_to_device_copies_are_not_hbm_traffic():
    with RL.count_cost() as counter:
        x = torch.ones(4).to("meta")
        (x + 1)
    assert counter.cost.hbm_by_op == {"aten::ones": 16, "aten::add.Tensor": 32}


def test_memory_peak_arguments_and_outputs():
    x = torch.empty((256,), dtype=torch.float32, device="meta")
    with RL.count_cost(memory_device="meta") as counter:
        counter.arguments(x, x[:10])               # one storage
        y = x * 2
        z = y + 1
        del y
        w = z.sum()
        counter.outputs((z, w, z[1:]))
    mem = counter.cost.memory()
    assert mem["argument_bytes"] == 1024
    assert mem["peak_bytes"] == 3 * 1024
    assert mem["temp_bytes"] == 2 * 1024
    assert mem["output_bytes"] == 1024 + 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_flash_call_is_costed_by_the_kernels_formula(device, monkeypatch):
    """Above CHUNKED_THRESHOLD attention is the flash op: its plain version
    on the CPU and its shape function on meta are costed alike, by
    ``kernels.work``, forward and backward, whatever aten ops the plain
    version issues."""
    monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", 16)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 64, 4, 16)).astype(np.float32)).to(device)
    k, v = (torch.from_numpy(rng.normal(size=(2, 64, 2, 16)).astype(np.float32)).to(device)
            for _ in range(2))
    q.requires_grad_(True)
    with RL.count_cost() as counter:
        out = ops.flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
        torch.autograd.grad(out.sum(), q)
    fwd = counter.cost.kernel_ops["flash_attention"]
    bwd = counter.cost.kernel_ops["flash_attention_bwd"]
    pairs = 64 * 65 // 2
    assert fwd["calls"] == bwd["calls"] == 1
    assert fwd["ops"] == {"bfloat16": 6 * 4 * 16 * 2 * 4 * pairs}
    assert fwd["bytes"] == (2 * q.numel() + 2 * k.numel()) * 4 + 2 * 4 * 64 * 4
    assert bwd["ops"] == {"bfloat16": 6 * 10 * 16 * 2 * 4 * pairs}
    assert bwd["bytes"] == (4 * q.numel() + 4 * k.numel()) * 4 + 2 * 4 * 64 * 4
    # no product of the plain version counted: only the kernels' work
    assert set(counter.cost.flops_by_dtype) == {"bfloat16"}


def test_reduced_forward_counts_equal_on_cpu_and_meta():
    for arch in ("qwen2.5-3b", "mamba2-370m"):
        cpu, meta = _port_forward_cost(arch, "cpu"), _port_forward_cost(arch)
        assert cpu.flops_by_dtype == meta.flops_by_dtype
        assert cpu.hbm_bytes == meta.hbm_bytes


# ---------------------------------------------------------------------------
# Roofline and the peaks
# ---------------------------------------------------------------------------

def test_roofline_terms_and_dominant():
    r = RL.Roofline.build(flops={"bfloat16": work.BF16_TENSOR_FLOPS_PER_S,
                                 "float32": work.F32_FLOPS_PER_S / 2},
                          hbm_bytes=work.HBM_BYTES_PER_S / 4,
                          wire_bytes=work.NVLINK_BYTES_PER_S * 2,
                          model_flops=work.BF16_TENSOR_FLOPS_PER_S / 2)
    assert r.compute_s == pytest.approx(1.5)
    assert r.memory_s == pytest.approx(0.25)
    assert r.collective_s == pytest.approx(2.0)
    assert r.dominant == "collective"
    assert r.bound_s == pytest.approx(1.5)
    assert r.useful_ratio == pytest.approx(
        work.BF16_TENSOR_FLOPS_PER_S / 2 / (work.BF16_TENSOR_FLOPS_PER_S
                                            + work.F32_FLOPS_PER_S / 2))
    m = RL.Roofline.build(flops=1e12, hbm_bytes=work.HBM_BYTES_PER_S, wire_bytes=0.0)
    assert m.dominant == "memory" and m.flops_by_dtype == {"bfloat16": 1e12}
    c = RL.Roofline.build(flops={"int32": work.INT32_OPS_PER_S}, hbm_bytes=0.0,
                          wire_bytes=0.0)
    assert c.dominant == "compute" and c.flops == 0 and c.compute_s == pytest.approx(1.0)
    assert set(r.as_dict()) >= {"flops", "hbm_bytes", "wire_bytes", "compute_s", "memory_s",
                                "collective_s", "dominant", "model_flops", "useful_ratio"}


def test_peaks_are_one_h100s():
    assert work.HBM_BYTES_PER_S == 3.35e12
    assert work.BF16_TENSOR_FLOPS_PER_S == 989e12
    assert work.F32_FLOPS_PER_S == 132 * 128 * 2 * 1.98e9
    assert work.INT32_OPS_PER_S == 132 * 64 * 1.98e9
    assert work.NVLINK_BYTES_PER_S == 450e9


# ---------------------------------------------------------------------------
# the kernel formulas at the kernel table's shapes (PERF.md)
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.int64):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_work_formulas_give_the_kernel_tables_bounds():
    cfg_d, cfg_s, t, w, batch = 6, 3, 3, 1024, 65_536
    lat = proj.padded_lattice(cfg_d, cfg_s)
    L, m_max = len(lat.nums), max(lat.nums)
    ingest = work.op_work("fused_ingest", (
        _meta((L, t, w), torch.int32), _meta((batch, cfg_d)), _meta((L, m_max, cfg_d)),
        _meta((L, m_max)), _meta((2,)), _meta((L, t, 2, 4)), _meta((L, t, 2, 4)),
        _meta((batch, L, m_max), torch.int32)), {}, None)
    assert ingest.nbytes == 12_683_168                                   # row 1
    assert round(work.bound_ms(ingest.nbytes, 0)[0], 5) == 0.00379
    sargs = (_meta((2,)), None, None, batch, cfg_d, cfg_s, 0.5)
    sample = work.op_work("sample_weights", sargs, {}, work.sample_weights_shape(*sargs))
    assert sample.ops == {"int32": 202_900_392}                          # row S
    assert round(work.work_ms(sample)[0], 5) == 0.01213
    fp = work.op_work("fingerprint", (_meta((batch, cfg_d)), _meta((20, cfg_d)), _meta((20,)),
                                      _meta((2,))), {}, None)
    assert round(work.work_ms(fp)[0], 5) == 0.00360                      # row 2
    tenants = _meta((1024, L, t, w), torch.int32)
    query = work.op_work("fused_query", (tenants, tenants), {}, _meta((1024, L, t)))
    assert round(work.work_ms(query)[0], 5) == 0.01504                   # row 3
    n = 81_920
    update = work.op_work("sketch_update", (_meta((t, w), torch.int32), _meta((n,)),
                                            _meta((n,)), _meta((t, 2, 4)), _meta((t, 2, 4)),
                                            _meta((n,), torch.int32)), {}, None)
    assert round(work.work_ms(update)[0], 6) == 0.000301                 # row 5
    counters = _meta((t, w), torch.int32)
    moments = work.op_work("sketch_moments", (counters, counters), {}, _meta((t,)))
    assert round(work.work_ms(moments)[0], 7) == 0.0000037               # row 6
    for batch_, dtype, fwd_ms, bwd_ms in ((4, torch.float32, 10.424, None),
                                          (4, torch.bfloat16, 1.737, None),
                                          (1, torch.bfloat16, None, 1.086),
                                          (1, torch.float32, None, 6.515)):
        q = _meta((batch_, 10_240, 16, 128), dtype)
        k = _meta((batch_, 10_240, 2, 128), dtype)
        if fwd_ms is not None:                                           # row 7
            got = work.op_work("flash_attention", (q, k, k), {"causal": True}, q)
            assert round(work.work_ms(got)[0], 3) == fwd_ms
        else:                                                            # row 7b
            lse = _meta((batch_, 16, 10_240), torch.float32)
            got = work.op_work("flash_attention_bwd", (q, k, k, q, lse, q),
                               {"causal": True}, (q, k, k))
            assert round(work.work_ms(got)[0], 3) == bwd_ms


def test_exact_counts_read_the_data():
    rng = np.random.default_rng(2)
    valid = torch.from_numpy((rng.random((3, 9)) < 0.6).astype(np.int32))
    items = torch.zeros((3, 9, 4), dtype=torch.int64)
    m = valid.sum(dim=1)
    exact = work.op_work("fused_pairs", (items, valid), {}, None, exact=True)
    assert exact.ops == {"int32": 4 * int((m * (m - 1) // 2).sum())}
    assert work.op_work("fused_pairs", (items, valid), {}, None).ops == {"int32": 0}
    masks = torch.from_numpy(proj.lattice(6, 4)[0].masks.astype(np.int64))     # k = 4
    fargs = (items[0], masks, masks[:, 0], masks[0, :2])
    assert work.op_work("fingerprint", fargs, {}, None, exact=True).ops == {
        "int32": 2 * 4 * 9 * 15}
    # C(6, 4) = C(6, 2): without the data, the fewer columns
    assert work.op_work("fingerprint", fargs, {}, None).ops == {"int32": 2 * 2 * 9 * 15}


@pytest.mark.parametrize("op", sorted(work.SHAPES))
def test_meta_tier_is_selected_for_meta_tensors_only(op):
    from repro_torch.kernels import registry
    reg = registry.kernel_registry()
    assert reg.select(op, torch.device("meta")) == (registry.META, work.SHAPES[op])
    assert reg.select(op, torch.device("cpu"))[0] == registry.TORCH_REF
    assert reg.select(op, torch.device("cuda"))[0] == registry.CUDA_SM90


def test_new_modules_import_without_jax():
    code = ("import sys; import repro_torch.launch.roofline, repro_torch.launch.dryrun, "
            "repro_torch.kernels.work; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
