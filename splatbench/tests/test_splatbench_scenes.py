"""``splatbench/scenes.py``: deterministic per seed, and the statistics of
the port's host generator ``utils/synthetic.outdoor_scene``."""

import torch

from splatbench import scenes
from unitygaussiansplatting_torch.utils.synthetic import outdoor_scene

N = 20_000


def test_same_seed_same_scene_other_seed_other_scene():
    a = scenes.outdoor_scene(N, 2**31 + 11, "cpu")
    b = scenes.outdoor_scene(N, 2**31 + 11, "cpu")
    c = scenes.outdoor_scene(N, 2**31 + 12, "cpu")
    for k in scenes.RAW_FIELDS:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    t = scenes.targets(2, 16, 8, 5, "cpu")
    assert torch.equal(t, scenes.targets(2, 16, 8, 5, "cpu")) and t.shape == (2, 8, 16, 3)


def _stats(x: torch.Tensor) -> torch.Tensor:
    """Per column: mean, std and the 10/50/90% quantiles."""
    x = x.reshape(x.shape[0], -1).double()
    q = torch.quantile(x[:, :48], torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64), dim=0)
    return torch.cat([x[:, :48].mean(0, keepdim=True), x[:, :48].std(0, keepdim=True), q])


def test_statistics_match_the_port_generator():
    ours = scenes.outdoor_scene(N, 7, "cpu")
    host = outdoor_scene(n=N, seed=7)
    for k in scenes.RAW_FIELDS:
        a, b = _stats(ours[k]), _stats(getattr(host, k))
        scale = getattr(host, k).reshape(N, -1)[:, :48].double().std(0)
        # 20k draws: a mean within ~0.7% of a std, a quantile within ~1.5%.
        assert torch.all((a - b).abs() <= 0.06 * scale + 1e-6), (k, (a - b).abs().max())
    solid = (ours["opacity_logits"] > 0.5).double().mean()
    assert abs(float(solid) - float((host.opacity_logits > 0.5).double().mean())) < 0.02


def test_morton_order_is_spatially_coherent():
    ours = scenes.outdoor_scene(N, 3, "cpu")
    step = (ours["means"][1:] - ours["means"][:-1]).norm(dim=1).median()
    shuffled = ours["means"][torch.randperm(N, generator=torch.Generator().manual_seed(0))]
    assert step < 0.1 * (shuffled[1:] - shuffled[:-1]).norm(dim=1).median()
