"""The tunes of the samplers this slice ports, carried from the JAX package
into the port and back without loss, and carried by the port's restart.

A JAX block's tune is made per chain (``jax.vmap`` of the block's ``init``
over the chain keys and the chain-stacked state, as the JAX engine makes
it); the converter takes it to the port's tune, ``tune_to_numpy`` back to
numpy, and every field must come back equal: per chain where the port
keeps one value per chain, once where it keeps one for all (the converter
checks that every chain holds the same value).  The converted tune then
drives one step of the port's block."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu_torch.model.mcmc import _chain_inits
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

C = 3
#: (model, scheme, block index, converter, fields kept once for all chains)
BLOCKS = [
    ("eyes", None, 0, "dgs_tune", ("support", "mask")),
    ("eyes", None, 3, "slicesimplex_tune", ("scale",)),
    ("asthma", None, 0, "slicesimplex_tune", ("scale",)),
    ("pollution", "bhmc", 0, "bhmc_tune", ("traveltime",)),
    ("pollution", "bia", 0, "bia_tune", ("epsilon", "decay", "target", "iter")),
    ("pollution", "bmc3", 0, "index_tune", ("groups_mask", "k")),
    ("pollution", "bmg", 0, "index_tune", ("groups_mask", "k")),
    ("line_abc", None, 0, "abc_tune", ()),
    ("gk", None, 0, "abc_tune", ()),
]


def _build(pkg, name, scheme):
    mod = importlib.import_module(f"{pkg}.models.{name}")
    return mod.build() if scheme is None else mod.build(scheme)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name,scheme,index,conv,shared", BLOCKS,
                         ids=[f"{b[0]}-{b[3]}" for b in BLOCKS])
def test_tune_goes_from_jax_to_the_port_and_back(name, scheme, index, conv, shared):
    jm, jin, jinits = _build("mamba_tpu", name, scheme)
    tm, tin, tinits = _build("mamba_tpu_torch", name, scheme)
    jcm = jmt.compile_model(jm, jin, jinits[0])
    tcm = tmt.compile_model(tm, tin, tinits[0], device="cpu")
    state = _chain_inits(tcm, tinits, C)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    jblock = jm.samplers[index].build(jcm)
    jtune = jax.vmap(jblock.init)(jax.random.split(jax.random.key(1), C), jstate)
    if isinstance(jtune, tuple) and not hasattr(jtune, "_fields"):
        (jtune,) = jtune                          # DGS: one tune per node
    fields = convert._fields(_np(jtune))
    ttune = getattr(convert, conv)(fields, "cpu", torch.float64)
    back = convert.tune_to_numpy(ttune)
    assert set(back) == set(fields)
    for f, want in fields.items():
        if want is None:
            assert back[f] is None, f
            continue
        want = np.asarray(want)
        if f in shared:
            want = want[0] if want.ndim else want
        np.testing.assert_array_equal(back[f], want, err_msg=f)

    # the converted tune drives the port's block
    tblock = tm.samplers[index].build(tcm)
    if conv == "dgs_tune":
        ttune = (ttune,)
    st, t2 = tblock.step(torch.Generator().manual_seed(0), state, ttune, True)
    for v in st.values():
        assert torch.isfinite(v).all()
    assert type(t2) is type(ttune)


def test_a_shared_field_that_differs_across_chains_is_refused():
    bad = {"scale": np.array([0.5, 0.7])}
    with pytest.raises(ValueError, match="shared"):
        convert.slicesimplex_tune(bad, "cpu", torch.float64)


@pytest.mark.parametrize("scheme", ["bia", "bhmc"])
def test_restart_carries_the_tunes(scheme):
    from mamba_tpu_torch.models import pollution
    model, inputs, inits = pollution.build(scheme)
    sim = tmt.mcmc(model, inputs, inits, 4, burnin=2, chains=2, verbose=False,
                   device="cpu")
    t0 = sim.states["tunes"][0]
    sim2 = tmt.mcmc(sim, 3, verbose=False)
    t1 = sim2.states["tunes"][0]
    assert sim2.value.shape[0] == 5
    if scheme == "bia":
        assert t0.iter == 4 and t1.iter == 7
        assert not torch.equal(t0.A, t1.A)
    else:
        assert (t1.wallhits > t0.wallhits).all()     # summed over trajectories
