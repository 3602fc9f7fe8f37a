"""The parallel package's device defaults: `devices_for` and
`topology_summary` run on the card when given no device, and where there is
no card they raise and say to pass `device="cpu"`, as `default_device` does;
they never land on the CPU on their own. The card's absence is simulated, so
these run the same with a card or without one."""

import pytest
import torch

from two_tower_recommender_model_tpu_torch.parallel.launch import TrainingMethod, devices_for
from two_tower_recommender_model_tpu_torch.parallel.mesh import topology_summary


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("method", list(TrainingMethod))
def test_devices_for_without_a_device_raises_where_there_is_no_card(no_card, method):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        devices_for(method)


@pytest.mark.parametrize("method", list(TrainingMethod))
@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_devices_for_takes_the_cpu_when_asked(no_card, method, device):
    assert devices_for(method, device=device) == [torch.device("cpu")]


def test_topology_summary_without_a_device_raises_where_there_is_no_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        topology_summary()


def test_topology_summary_takes_the_cpu_when_asked(no_card):
    topo = topology_summary("cpu")
    assert (topo.platform, topo.device_kind, topo.hbm_bytes_per_device) == ("cpu", "cpu", None)
    assert topo.num_devices == 1 and topo.num_hosts == 1
