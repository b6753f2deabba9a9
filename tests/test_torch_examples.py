"""The example twins ``examples/quickstart_torch.py`` and
``examples/serve_decode_torch.py`` on the CPU at small sizes, against the
JAX package's functions that their references run.

quickstart: the same records and the same keys (``fold_in(PRNGKey(0),
i)``, replayed by ``core/prng.py``) through ``sjpc.update`` of both
packages print the same g_s table, line for line.  serve_decode: the JAX
package's reduced qwen2-7b parameters carried over give the same greedy
tokens, and the request monitor the same estimate.  A subprocess imports
the nine twins and finds no ``jax`` or ``repro`` module.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import exact as jexact  # noqa: E402
from repro.core import sjpc as jsjpc  # noqa: E402
from repro.data.synthetic import shingle_records as jshingle_records  # noqa: E402
from repro.launch.serve import greedy_generate as jgreedy_generate  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro.sketchstream import monitor as jmon  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.config import compute_dims as tcompute_dims  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("quickstart", "serve_decode", "batched_queries", "serve_estimates",
         "equal_space_serving", "planner_admission", "observability", "join_contamination",
         "distributed_scaleout")


def _example(name):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        return __import__(f"{name}_torch")
    finally:
        sys.path.pop(0)


def test_quickstart_table_equals_the_reference(capsys):
    records_n, batch = 2_000, 500
    quickstart = _example("quickstart")
    rows = quickstart.main(["--device", "cpu", "--records", str(records_n),
                            "--batch", str(batch)])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert "sketch memory: 48 KiB (4 levels x 3 x 1024 int32)" in out

    # the reference's loop (examples/quickstart.py) at the same size
    records = jshingle_records(records_n, d=6, seed=1, group=6,
                               dup_profile=quickstart.DUP_PROFILE)
    cfg = jsjpc.SJPCConfig(d=6, s=3, ratio=0.5, width=1024, depth=3)
    params, state = jsjpc.init(cfg)
    update = jax.jit(lambda st, b, key: jsjpc.update(cfg, params, st, b, key))
    key = jax.random.PRNGKey(0)
    for i in range(0, records_n, batch):
        state = update(state, jnp.asarray(records[i:i + batch]), jax.random.fold_in(key, i))
    est = jsjpc.estimate(cfg, state)
    want = []
    for s in range(3, 7):
        g_est = est.x[s - 3:].sum() + est.n
        g_true = jexact.exact_g(records, s)
        want.append(f"{s:>2} {g_est:>14.0f} {g_true:>14.0f} "
                    f"{abs(g_est - g_true) / g_true:>8.3f}")
        got = rows[s - 3]
        assert got[0] == s and got[2] == float(g_true)
        assert abs(got[1] - float(g_est)) <= 1e-6 * max(float(g_est), 1.0)
    table = out.splitlines()[-4:]
    assert table == want


def test_serve_decode_tokens_and_monitor_equal_the_reference(capsys):
    serve_decode = _example("serve_decode")
    b, prompt, gen = 8, 24, 4
    jcfg = jconfigs.reduced("qwen2-7b")
    jdims = jcompute_dims(jcfg, tp=1)
    jparams = jM.strip_p(jM.init_params(jax.random.PRNGKey(0), jcfg, jdims))
    tcfg = tconfigs.reduced("qwen2-7b")
    tdims = tcompute_dims(tcfg, tp=1)
    prompts = serve_decode.prompts_of(tcfg, b, prompt)
    rng = np.random.default_rng(5)                      # the reference's requests
    ref_prompts = rng.integers(0, jcfg.vocab_size, size=(b, prompt), dtype=np.int32)
    ref_prompts[3] = ref_prompts[0]
    ref_prompts[5] = ref_prompts[0]
    assert np.array_equal(prompts, ref_prompts)

    want = np.asarray(jgreedy_generate(jparams, jcfg, jdims, jnp.asarray(prompts), gen))
    tparams = convert.model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                              device="cpu")
    got = serve_decode.serve(tparams, tcfg, tdims, prompts, gen)
    assert np.array_equal(got, want)

    mcfg = jmon.SketchMonitorConfig(d=4, s=4, ratio=1.0, width=1024, depth=3, shards=1)
    mparams, mstate = jmon.init_monitor(mcfg)
    c, n = jmon.monitor_update_local(mcfg, mparams, mstate.counters[0], mstate.n[0],
                                     jnp.asarray(prompts), jnp.zeros((), jnp.int32))
    est = jmon.monitor_estimate(mcfg, jmon.MonitorState(c[None], n[None], mstate.step))
    want_pairs = (est["g"][4] - b) / 2
    got_pairs = serve_decode.monitor(prompts, "cpu")
    assert abs(got_pairs - want_pairs) <= 1e-6 * max(abs(want_pairs), 1.0)

    out = serve_decode.main(["--device", "cpu", "--gen", "3"])
    printed = capsys.readouterr().out
    assert f"served {b} requests, prompt={prompt} tokens, generated 3 each" in printed
    assert all(f"  req {i}: ..." in printed for i in range(b))
    assert "SJPC request monitor: ~" in printed and "(true: 3)" in printed
    assert out["tokens"].shape == (b, 3)
    assert np.array_equal(out["tokens"][0], out["tokens"][3])
    assert np.array_equal(out["tokens"][0], out["tokens"][5])


def test_twins_import_no_jax():
    code = ("import sys, os\n"
            f"sys.path.insert(0, {os.path.join(REPO, 'examples')!r})\n"
            + "".join(f"import {name}_torch\n" for name in TWINS)
            + "bad = [m for m in sys.modules if m in ('jax', 'repro') "
              "or m.startswith(('jax.', 'repro.'))]\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
