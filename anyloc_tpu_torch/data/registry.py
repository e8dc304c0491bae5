"""Dataset registry — replaces the 10-way if-chain every reference script
repeats (e.g. dino_v2_global_vocab_vlad.py:500-523) with one lookup keyed by
the reference's dataset names (configs.py:79). A copy of
``anyloc_tpu/data/registry.py``."""

from __future__ import annotations

from typing import Optional, Tuple


def get_dataset(
    name: str,
    datasets_folder: str,
    split: str = "test",
    img_size: Optional[Tuple[int, int]] = (320, 320),
    dist_thresh: float = 25.0,
    **kwargs,
):
    from anyloc_tpu_torch.data import loaders as L

    if name == "baidu_datasets":
        return L.Baidu(datasets_folder, name, img_size=img_size, **kwargs)
    if name == "Oxford":
        return L.Oxford(datasets_folder, img_size=img_size, **kwargs)
    if name == "Oxford_25m":
        return L.Oxford(datasets_folder, override_dist=25, img_size=img_size, **kwargs)
    if name == "gardens":
        return L.Gardens(datasets_folder, name, img_size=img_size, **kwargs)
    if name.startswith("Tartan_GNSS"):
        return L.Aerial(datasets_folder, name, img_size=img_size, **kwargs)
    if name.startswith("hawkins"):
        return L.Hawkins(
            datasets_folder, "hawkins_long_corridor", img_size=img_size, **kwargs
        )
    if name == "VPAir":
        return L.VPAir(datasets_folder, name, img_size=img_size, **kwargs)
    if name == "VPAir_distractor":
        return L.VPAirDistractor(datasets_folder, "VPAir", img_size=img_size, **kwargs)
    if name == "laurel_caverns":
        return L.Laurel(datasets_folder, name, img_size=img_size, **kwargs)
    if name == "eiffel":
        return L.Eiffel(datasets_folder, name, img_size=img_size, **kwargs)
    if name == "NVL_datasets":
        return L.NaverLabs(datasets_folder, name, img_size=img_size, **kwargs)
    # pitts30k, st_lucia, 17places, nordland, tokyo247, ... (dual-layout)
    return L.BaseDataset(
        datasets_folder, name, split, dist_thresh=dist_thresh,
        img_size=img_size, **kwargs,
    )


def dataset_names():
    """The reference's supported set (configs.py:79)."""
    return [
        "st_lucia", "pitts30k", "17places", "nordland", "tokyo247",
        "baidu_datasets", "Oxford", "Oxford_25m", "gardens",
        "hawkins", "hawkins_long_corridor", "VPAir",
        "Tartan_GNSS_rotated", "Tartan_GNSS_notrotated",
        "Tartan_GNSS_test_notrotated", "Tartan_GNSS_test_rotated",
        "laurel_caverns", "eiffel",
    ]


# Domain vocabularies: dataset -> sub-sample frequency, from the reference's
# ablation recipes (dino_v2_global_vocab_vlad.py docstring :9-58).
DOMAIN_RECIPES = {
    "indoor": {"baidu_datasets": 1, "gardens": 1, "17places": 1},
    "urban": {"Oxford": 1, "st_lucia": 1, "pitts30k": 4},
    "aerial": {
        "Tartan_GNSS_test_rotated": 1,
        "Tartan_GNSS_test_notrotated": 1,
        "VPAir": 2,
    },
    "hawkins": {"hawkins": 1},
    "laurel_caverns": {"laurel_caverns": 1},
    "structured": {
        "Oxford": 1, "gardens": 1, "17places": 1,
        "baidu_datasets": 1, "st_lucia": 1, "pitts30k": 4,
    },
    "unstructured": {
        "Tartan_GNSS_test_rotated": 1, "Tartan_GNSS_test_notrotated": 1,
        "hawkins": 1, "laurel_caverns": 1, "eiffel": 1, "VPAir": 2,
    },
}
DOMAIN_RECIPES["both"] = {
    **DOMAIN_RECIPES["structured"],
    **DOMAIN_RECIPES["unstructured"],
}
