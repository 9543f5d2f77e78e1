"""Port vs reference, host-side numpy modules: road nets, mobility, contact
windows, the D_max probe, partitions and the synthetic data are copies, so
they must be BIT-equal per seed (no tolerance: same numpy code, same seeds).
"""
import numpy as np
import pytest

from repro.data import synthetic as ref_synth
from repro.fed import engine as ref_engine
from repro.fed import extensions as ref_ext
from repro.fed import mobility as ref_mob
from repro.fed import partition as ref_part
from repro.fed import topology as ref_topo
from repro_torch.data import synthetic as synth
from repro_torch.fed import engine
from repro_torch.fed import extensions as ext
from repro_torch.fed import mobility as mob
from repro_torch.fed import partition as part
from repro_torch.fed import topology as topo


@pytest.mark.parametrize("name", ["grid", "random", "spider", "highway"])
@pytest.mark.parametrize("seed", [0, 3])
def test_road_networks_bit_equal(name, seed):
    a = ref_topo.make_road_network(name, seed=seed)
    b = topo.make_road_network(name, seed=seed)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.edges, b.edges)
    assert topo.available_road_networks() == ref_topo.available_road_networks()


def _mobility_pair(name, seed, k=9):
    out = []
    for t, m in ((ref_topo, ref_mob), (topo, mob)):
        net = t.make_road_network("grid", seed=seed)
        out.append(m.make_mobility(name, net, m.MobilityConfig(
            num_vehicles=k, epoch_duration=30.0, comm_range=100.0, seed=seed)))
    return out


@pytest.mark.parametrize("name", sorted(ref_mob.available_mobility_models()))
def test_advance_positions_bit_equal(name):
    assert mob.available_mobility_models() == ref_mob.available_mobility_models()
    a, b = _mobility_pair(name, seed=1)
    np.testing.assert_array_equal(a.advance_positions(5), b.advance_positions(5))
    np.testing.assert_array_equal(a.advance_positions(3), b.advance_positions(3))


@pytest.mark.parametrize("num_rsus,p_drop", [(0, 0.0), (2, 0.0), (0, 0.3), (3, 0.25)])
def test_contact_and_neighbour_windows_bit_equal(num_rsus, p_drop):
    a, b = _mobility_pair("manhattan", seed=2, k=12)
    pos_a, pos_b = a.advance_positions(6), b.advance_positions(6)
    net_a = ref_topo.make_road_network("grid")
    net_b = topo.make_road_network("grid")
    rsu_a = ref_ext.place_rsus(net_a, num_rsus) if num_rsus else None
    rsu_b = ext.place_rsus(net_b, num_rsus) if num_rsus else None
    dense_a = ref_ext.contact_window(pos_a, rsu_a, 150.0, p_drop,
                                     np.random.default_rng(7))
    dense_b = ext.contact_window(pos_b, rsu_b, 150.0, p_drop,
                                 np.random.default_rng(7))
    np.testing.assert_array_equal(dense_a, dense_b)
    d = topo.max_contact_degree(dense_b)
    assert d == ref_topo.max_contact_degree(dense_a)
    idx_a, mask_a = ref_ext.neighbour_window(pos_a, rsu_a, 150.0, p_drop,
                                             np.random.default_rng(7), d)
    idx_b, mask_b = ext.neighbour_window(pos_b, rsu_b, 150.0, p_drop,
                                         np.random.default_rng(7), d)
    np.testing.assert_array_equal(idx_a, idx_b)
    np.testing.assert_array_equal(mask_a, mask_b)
    # the sparse window is the dense one, losslessly
    np.testing.assert_array_equal(topo.dense_from_neighbours(idx_b, mask_b),
                                  dense_b)
    np.testing.assert_array_equal(ext.rsu_local_step_mask(5, num_rsus),
                                  ref_ext.rsu_local_step_mask(5, num_rsus))


@pytest.mark.parametrize("kwargs", [
    dict(), dict(num_rsus=2), dict(p_drop=0.3), dict(road_net="spider", seed=4),
])
def test_probe_d_max_and_contact_stream_equal(kwargs):
    base = dict(num_vehicles=14, epochs=7, comm_range=180.0)
    cfg_a = ref_engine.SimulationConfig(**base, **kwargs)
    cfg_b = engine.SimulationConfig(**base, **kwargs, device="cpu")
    net_a = ref_topo.make_road_network(cfg_a.road_net, seed=cfg_a.seed)
    net_b = topo.make_road_network(cfg_b.road_net, seed=cfg_b.seed)
    assert engine.probe_d_max(cfg_b, net_b) == ref_engine.probe_d_max(cfg_a, net_a)
    assert (engine.probe_d_max(cfg_b, net_b, chunk=2)
            == ref_engine.probe_d_max(cfg_a, net_a, chunk=2))
    sa, sb = ref_engine.ContactStream(cfg_a, net_a), engine.ContactStream(cfg_b, net_b)
    assert sa.d_max == sb.d_max
    for length in (3, 4):   # chunked windows continue the same streams
        wa, wb = sa.window(length), sb.window(length)
        np.testing.assert_array_equal(np.asarray(wa.idx), wb.idx)
        np.testing.assert_array_equal(np.asarray(wa.mask), wb.mask)


@pytest.mark.parametrize("seed", [0, 5])
def test_partitions_bit_equal(seed):
    labels = np.random.default_rng(seed).integers(0, 10, size=900).astype(np.int32)
    a = ref_part.balanced_noniid(labels, 7, seed=seed)
    b = part.balanced_noniid(labels, 7, seed=seed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a = ref_part.unbalanced_iid(900, 7, size_choices=(20, 60, 180), seed=seed)
    b = part.unbalanced_iid(900, 7, size_choices=(20, 60, 180), seed=seed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    (da, ca), (db, cb) = ref_part.pad_to_uniform(a, seed=seed), part.pad_to_uniform(b, seed=seed)
    np.testing.assert_array_equal(da, db)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(ref_part.label_histogram(labels, a, 10),
                                  part.label_histogram(labels, b, 10))


@pytest.mark.parametrize("maker", ["synthetic_mnist", "synthetic_cifar10"])
def test_synthetic_data_bit_equal(maker):
    a = getattr(ref_synth, maker)(seed=3, n_train=64, n_test=16)
    b = getattr(synth, maker)(seed=3, n_train=64, n_test=16)
    assert a.name == b.name and a.num_classes == b.num_classes
    for field in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_load_dataset_falls_back_to_synthetic(monkeypatch, tmp_path):
    from repro_torch.data import datasets

    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))   # no real files there
    monkeypatch.setattr(datasets, "synthetic_mnist",
                        lambda seed=0: synth.synthetic_mnist(seed, 32, 8))
    ds = datasets.load_dataset("mnist", seed=2)
    assert ds.name == "synthetic-mnist" and ds.train_x.shape == (32, 28, 28, 1)
    with pytest.raises(ValueError):
        datasets.load_dataset("imagenet")
