"""The port's memsim and stencil spec against the JAX package's: the same
spec and seed give byte-identical bundle files, and the port's
``TraceBundle.load`` reads a bundle the reference saved."""
import pytest

from repro.apps.stencil.spec import StencilConfig as RefStencilConfig
from repro.apps.stencil.spec import build_spec as ref_build_spec
from repro.memsim import NetworkParams as RefNetworkParams
from repro.memsim import collect as ref_collect
from repro_torch.apps.stencil import StencilConfig, build_spec
from repro_torch.core import TraceBundle
from repro_torch.memsim import (DDR_LOCAL, OPTANE, NetworkParams, Scenario,
                                baseline_time, collect, reference_time)

#: (tile, grid, ranks_per_socket, network, seed)
CONFIGS = [
    (32, (8, 8), 6, "multinode", 0),
    (256, (4, 4), 8, "on_numa", 3),
    (1024, (8, 8), 6, "multinode", 0),
    (4096, (8, 8), 6, "multinode", 7),
]


def _pair(tile, grid, rps, network, seed):
    ref = ref_collect(
        ref_build_spec(RefStencilConfig(tile, grid=grid, ranks_per_socket=rps)),
        network=getattr(RefNetworkParams, network)(), seed=seed)
    port = collect(build_spec(StencilConfig(tile, grid=grid,
                                            ranks_per_socket=rps)),
                   network=getattr(NetworkParams, network)(), seed=seed)
    return ref, port


def _files(bundle):
    return (bundle.samples_csv(), bundle.comms_csv(), bundle.counters_json())


@pytest.mark.parametrize("tile,grid,rps,network,seed", CONFIGS)
def test_collect_matches_reference(tile, grid, rps, network, seed):
    ref, port = _pair(tile, grid, rps, network, seed)
    assert _files(port) == _files(ref)
    assert port.meta == ref.meta
    assert port.sampling_period == ref.sampling_period
    for cid, site in ref.call_sites.items():
        ps = port.call_sites[cid]
        assert (ps.accesses_per_element, ps.loads_per_line, ps.unpack) == \
            (site.accesses_per_element, site.loads_per_line, site.unpack)


@pytest.mark.parametrize("tile", [64, 2048])
def test_load_reads_reference_save(tmp_path, tile):
    ref, _ = _pair(tile, (8, 8), 6, "multinode", 1)
    ref.save(tmp_path / "bundle")
    loaded = TraceBundle.load(tmp_path / "bundle")
    assert _files(loaded) == _files(ref)
    assert list(loaded.call_sites) == list(ref.call_sites)
    loaded.save(tmp_path / "again")
    for name in ("samples.csv", "comms.csv", "counters.json", "meta.json"):
        assert (tmp_path / "again" / name).read_text() == \
            (tmp_path / "bundle" / name).read_text()


def test_reference_runs_match():
    """The engine-priced validation truth of the copied memsim."""
    from repro.memsim import DDR_LOCAL as R_DDR, OPTANE as R_OPT
    from repro.memsim import Scenario as RScenario
    from repro.memsim import baseline_time as r_baseline
    from repro.memsim import reference_time as r_reference
    spec = build_spec(StencilConfig(256))
    rspec = ref_build_spec(RefStencilConfig(256))
    calls = ("halo_N", "halo_S")
    assert baseline_time(spec) == r_baseline(rspec)
    assert reference_time(spec, Scenario("o", OPTANE, calls)) == \
        r_reference(rspec, RScenario("o", R_OPT, calls))
    assert reference_time(spec, Scenario("d", DDR_LOCAL, calls)) == \
        r_reference(rspec, RScenario("d", R_DDR, calls))
