"""The port's configs and segment layouts equal the JAX package's, field by
field, for all 10 archs, base and reduced, with and without a dbpim
mode."""

import dataclasses

import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import config as jconfig
from repro.models import segments as jseg
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import config as tconfig
from repro_torch.models import segments as tseg

pytestmark = pytest.mark.port

MODES = (None, "dense", "value", "bit", "joint")


def test_arch_lists_equal():
    assert ARCHS == JAX_ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_config_fields_and_layouts_equal(arch, reduced):
    for mode in MODES:
        for prefill_exact in (None, True):
            ref = jax_get_config(arch, reduced=reduced, dbpim_mode=mode,
                                 prefill_exact=prefill_exact)
            mine = get_config(arch, reduced=reduced, dbpim_mode=mode,
                              prefill_exact=prefill_exact)
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            if ref.n_heads:                 # attention-free: no head dims
                assert (mine.hd, mine.q_dim, mine.kv_dim) == \
                    (ref.hd, ref.q_dim, ref.kv_dim)
            assert tconfig.param_count(mine) == jconfig.param_count(ref)
            assert tconfig.active_param_count(mine) == \
                jconfig.active_param_count(ref)
    ref = jax_get_config(arch, reduced=reduced, dbpim_mode="joint")
    mine = get_config(arch, reduced=reduced, dbpim_mode="joint")
    segs, jsegs = tseg.decoder_layout(mine), jseg.decoder_layout(ref)
    assert [dataclasses.asdict(s) for s in segs] == \
        [dataclasses.asdict(s) for s in jsegs]
    assert [dataclasses.asdict(s) for s in tseg.encoder_layout(mine)] == \
        [dataclasses.asdict(s) for s in jseg.encoder_layout(ref)]
    for s, js in zip(segs, jsegs):
        names = tseg.packable_projections(s, mine)
        assert names == jseg.packable_projections(js, ref)
        assert [tseg.projection_param_path(s, n) for n in names] == \
            [jseg.projection_param_path(js, n) for n in names]
    caps, jcaps = mine.serving_capabilities(), ref.serving_capabilities()
    assert (caps.stacked_tables, caps.chunked_prefill, caps.parallel_prefill,
            caps.prefill_modes, caps.packable) == \
        (jcaps.stacked_tables, jcaps.chunked_prefill, jcaps.parallel_prefill,
         jcaps.prefill_modes, jcaps.packable)


def test_unknown_arch_and_mode_raise():
    with pytest.raises(KeyError):
        get_config("nope")
    with pytest.raises(KeyError):
        get_config("tinyllama-1.1b", dbpim_mode="sparse")
