"""``hgsfusion_tpu_torch.profile_serve``'s choice of the frame it profiles
(the profiling itself needs a CUDA device): the default gather config, the
polar view, and a config file in either view, the polar one with F2V QUANT
none (as the polar view refuses int8 maps); and its reading of a profiler
entry's device time under either field name."""
import types

import pytest

from hgsfusion_tpu_torch.config import vod_pallas_config, vod_polar_config
from hgsfusion_tpu_torch.profile_serve import device_us, frame_config

W8A8_YAML = "hgsfusion_tpu_torch/configs/hgsfusion_vod_w8a8.yaml"


@pytest.mark.parametrize("view,want", [(None, vod_pallas_config), ("gather", vod_pallas_config),
                                       ("polar", vod_polar_config)])
def test_frame_config_without_a_file(view, want):
    cfg, batch = frame_config(view)
    assert cfg == want()
    assert batch["images"].shape[1:3] == tuple(cfg.image_size)


@pytest.mark.parametrize("view", [None, "gather", "polar"])
def test_frame_config_of_a_file(view):
    cfg, batch = frame_config(view, W8A8_YAML)
    assert cfg.ddn_quant == "w8a8"
    assert cfg.f2v_view == ("polar" if view == "polar" else "gather")
    assert cfg.f2v_quant == ("none" if view == "polar" else "int8")
    assert batch["images"].shape[1:3] == tuple(cfg.image_size)


@pytest.mark.parametrize("prefix", ["device", "cuda"])
def test_device_us_reads_either_field(prefix):
    """Newer torch names an entry's device time ``*_device_time_total``,
    older ``*_cuda_time_total``: ``device_us`` reads either, its own time or
    with its children's."""
    event = types.SimpleNamespace(**{f"self_{prefix}_time_total": 3.0,
                                     f"{prefix}_time_total": 7.0})
    assert device_us(event, True) == 3.0
    assert device_us(event, False) == 7.0
