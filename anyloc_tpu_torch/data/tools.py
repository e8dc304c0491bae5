"""Dataset format tooling — the ``datasets_vg/`` layer of the reference
(util.py, format_*.py, map_builder.py), rebuilt without the unavailable
deps (utm / staticmap are not used; matplotlib is imported only by the map).
A copy of ``anyloc_tpu/data/tools.py`` without its downloader, which only
downloads:

  * ``build_utm_filename`` / ``format_image_dir`` — the
    ``@utm_east@utm_north@...@.jpg`` naming convention every vg_bench layout
    dataset uses (e.g. datasets_vg/format_pitts30k.py);
  * ``latlon_to_utm`` — WGS84 -> UTM (own implementation; the 'utm' pip
    package isn't in this image);
  * ``build_map_from_dataset`` — dataset map figure from the UTM/GPS
    coordinates parsed out of filenames (map_builder.py:107-163; matplotlib
    scatter instead of downloading OSM tiles).
"""

from __future__ import annotations

import glob
import math
import os
import re
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np


def get_distance(coords_a, coords_b) -> float:
    return math.sqrt(
        (float(coords_b[0]) - float(coords_a[0])) ** 2
        + (float(coords_b[1]) - float(coords_a[1])) ** 2
    )


def is_valid_timestamp(ts: str) -> bool:
    """YYYYMMDD_hhmmss with all fields left-to-right optional (util.py:54+)."""
    return bool(re.fullmatch(r"(\d{4}(\d{2}(\d{2}(_(\d{2})(\d{2})?(\d{2})?)?)?)?)?", ts))


# ---------------------------------------------------------------------------
# UTM conversion (WGS84 -> UTM, standard Karney-free series approximation —
# the same math the 'utm' pip package implements)
# ---------------------------------------------------------------------------

def latlon_to_utm(lat: float, lon: float) -> Tuple[float, float, int, str]:
    """-> (easting, northing, zone_number, zone_letter)."""
    a = 6378137.0
    f = 1 / 298.257223563
    k0 = 0.9996
    e2 = f * (2 - f)
    ep2 = e2 / (1 - e2)
    zone = int((lon + 180) / 6) + 1
    letters = "CDEFGHJKLMNPQRSTUVWXX"
    letter = letters[int((lat + 80) / 8)] if -80 <= lat <= 84 else "Z"
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)
    phi = math.radians(lat)
    lam = math.radians(lon)
    n = a / math.sqrt(1 - e2 * math.sin(phi) ** 2)
    t = math.tan(phi) ** 2
    c = ep2 * math.cos(phi) ** 2
    aa = math.cos(phi) * (lam - lon0)
    m = a * (
        (1 - e2 / 4 - 3 * e2 ** 2 / 64 - 5 * e2 ** 3 / 256) * phi
        - (3 * e2 / 8 + 3 * e2 ** 2 / 32 + 45 * e2 ** 3 / 1024) * math.sin(2 * phi)
        + (15 * e2 ** 2 / 256 + 45 * e2 ** 3 / 1024) * math.sin(4 * phi)
        - (35 * e2 ** 3 / 3072) * math.sin(6 * phi)
    )
    easting = k0 * n * (
        aa + (1 - t + c) * aa ** 3 / 6
        + (5 - 18 * t + t ** 2 + 72 * c - 58 * ep2) * aa ** 5 / 120
    ) + 500000.0
    northing = k0 * (
        m + n * math.tan(phi) * (
            aa ** 2 / 2 + (5 - t + 9 * c + 4 * c ** 2) * aa ** 4 / 24
            + (61 - 58 * t + t ** 2 + 600 * c - 330 * ep2) * aa ** 6 / 720
        )
    )
    if lat < 0:
        northing += 10000000.0
    return easting, northing, zone, letter


# ---------------------------------------------------------------------------
# vg_bench filename convention
# ---------------------------------------------------------------------------

def build_utm_filename(
    utm_east: float,
    utm_north: float,
    heading: float = 0.0,
    timestamp: str = "",
    note: str = "",
    extension: str = "jpg",
) -> str:
    """``@utm_east@utm_north@...@.jpg`` (the 23-field convention; unused
    fields empty — matches the formatters in datasets_vg/format_*.py)."""
    fields = [f"{utm_east:.2f}", f"{utm_north:.2f}", "", "", "", "", "", "",
              "", f"{heading:.2f}", "", "", "", "", timestamp, note, ""]
    return "@" + "@".join(fields) + f"@.{extension}"


def parse_utm_filename(name: str) -> Tuple[float, float]:
    parts = os.path.basename(name).split("@")
    return float(parts[1]), float(parts[2])


def format_image_dir(
    src_dir: str,
    dst_dir: str,
    coords: Sequence[Tuple[float, float]],
    is_latlon: bool = False,
    move: bool = False,
    extension: str = "jpg",
) -> List[str]:
    """Rename/copy a directory of images into the vg_bench convention given
    per-image coordinates (the shared core of format_pitts30k/format_*)."""
    from anyloc_tpu_torch.data.base import natsorted

    srcs = natsorted(glob.glob(os.path.join(src_dir, f"*.{extension}")))
    if len(srcs) != len(coords):
        raise ValueError(f"{len(srcs)} images in {src_dir} but {len(coords)} coordinates")
    os.makedirs(dst_dir, exist_ok=True)
    out = []
    for src, (x, y) in zip(srcs, coords):
        if is_latlon:
            x, y, _, _ = latlon_to_utm(x, y)
        dst = os.path.join(dst_dir, build_utm_filename(x, y, extension=extension))
        (shutil.move if move else shutil.copy2)(src, dst)
        out.append(dst)
    return out


# ---------------------------------------------------------------------------
# Map rendering
# ---------------------------------------------------------------------------

def build_map_from_dataset(
    dataset_folder: str,
    output_path: Optional[str] = None,
    extension: str = "jpg",
):
    """Scatter-plot the database/query UTM positions parsed from filenames
    (map_builder.py:107-163 without OSM tile downloads). Returns the figure
    path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = {}
    for split in ("database", "queries"):
        paths = glob.glob(
            os.path.join(dataset_folder, "**", split, f"*.{extension}"),
            recursive=True,
        )
        if paths:
            groups[split] = np.array([parse_utm_filename(p) for p in paths])
    fig, ax = plt.subplots(figsize=(8, 8))
    colors = {"database": "tab:blue", "queries": "tab:red"}
    for split, xy in groups.items():
        ax.scatter(xy[:, 0], xy[:, 1], s=4, alpha=0.6,
                   color=colors[split], label=f"{split} ({len(xy)})")
    ax.set_xlabel("UTM east (m)")
    ax.set_ylabel("UTM north (m)")
    ax.legend()
    ax.set_aspect("equal")
    name = os.path.basename(os.path.normpath(dataset_folder))
    out = output_path or os.path.join(dataset_folder, f"map_{name}.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def format_coord(num, left: int = 2, right: int = 5) -> str:
    """'001.100'-style fixed-width coordinate (util.py:66-81 semantics:
    ``left`` integer digits including a '-' sign, ``right`` decimals)."""
    sign = "-" if float(num) < 0 else ""
    whole = f"{abs(float(num)):.{right}f}"   # round first: no carry bugs
    int_str, frac_str = whole.split(".")
    return f"{sign}{int_str.rjust(left - len(sign), '0')}.{frac_str}"


def get_dst_image_name(
    latitude,
    longitude,
    pano_id=None,
    tile_num=None,
    heading=None,
    pitch=None,
    roll=None,
    height=None,
    timestamp=None,
    note=None,
    extension: str = ".jpg",
) -> str:
    """The reference's exact vg_bench filename
    (``util.py:93-108``): ``@east@north@zone@letter@lat@lon@pano@tile@
    heading@pitch@roll@height@timestamp@note@.jpg`` — datasets formatted
    here and by the reference tools are mutually loadable."""
    e, n, zone, letter = latlon_to_utm(float(latitude), float(longitude))
    easting = format_coord(e, 7, 2)
    northing = format_coord(n, 7, 2)
    lat_s = format_coord(latitude, 3, 5)
    lon_s = format_coord(longitude, 4, 5)
    tile_num = f"{int(float(tile_num)):02d}" if tile_num is not None else ""
    heading = f"{int(float(heading)):03d}" if heading is not None else ""
    pitch = f"{int(float(pitch)):03d}" if pitch is not None else ""
    timestamp = f"{timestamp}" if timestamp is not None else ""
    note = f"{note}" if note is not None else ""
    if not is_valid_timestamp(timestamp):
        raise ValueError(f"{timestamp} is not in YYYYMMDD_hhmmss format")
    if roll is not None or height is not None:
        raise ValueError("roll/height not used by any dataset")
    return (
        f"@{easting}@{northing}@{zone:02d}@{letter}@{lat_s}@{lon_s}"
        f"@{pano_id or ''}@{tile_num}@{heading}@{pitch}@@"
        f"@{timestamp}@{note}@{extension}"
    )


# ---------------------------------------------------------------------------
# Dataset-specific formatters (datasets_vg/format_mapillary.py,
# format_tokyo247.py, format_pitts250k.py equivalents — no downloads; raw
# archives must already be on disk)
# ---------------------------------------------------------------------------

MSLS_TRAIN_CITIES = [
    "trondheim", "london", "boston", "melbourne", "amsterdam", "helsinki",
    "tokyo", "toronto", "saopaulo", "moscow", "zurich", "paris", "bangkok",
    "budapest", "austin", "berlin", "ottawa", "phoenix", "goa", "amman",
    "nairobi", "manila",
]


def format_mapillary(raw_root: str, out_root: str) -> int:
    """Mapillary SLS -> msls/{train,val}/{database,queries} with the UTM
    naming + ``day|night_direction_city`` notes (format_mapillary.py:1-54):
    panoramas skipped, test symlinked to val. Returns images moved."""
    moved = 0
    csvs = sorted(glob.glob(
        os.path.join(raw_root, "*", "*", "postprocessed.csv")
    ))
    for csv_path in csvs:
        with open(csv_path) as f:
            post = f.readlines()[1:]
        with open(csv_path.replace("postprocessed", "raw")) as f:
            raw = f.readlines()[1:]
        if len(raw) != len(post):
            raise ValueError(f"{csv_path}: {len(post)} rows, raw.csv {len(raw)}")
        csv_dir = os.path.dirname(csv_path)
        city_path, folder = os.path.split(csv_dir)
        city = os.path.basename(city_path)
        folder = "database" if folder == "database" else "queries"
        split = "train" if city in MSLS_TRAIN_CITIES else "val"
        dst_dir = os.path.join(out_root, "msls", split, folder)
        os.makedirs(dst_dir, exist_ok=True)
        for p_line, r_line in zip(post, raw):
            _, pano_id, lon, lat, _, ts, is_pano = r_line.split(",")
            if is_pano.strip() == "True":
                continue
            direction = p_line.split(",")[-1].strip().lower()
            day_night = "day" if p_line.split(",")[-2] == "False" else "night"
            name = get_dst_image_name(
                lat, lon, pano_id, timestamp=ts.replace("-", ""),
                note=f"{day_night}_{direction}_{city}",
            )
            src = os.path.join(csv_dir, "images", f"{pano_id}.jpg")
            shutil.move(src, os.path.join(dst_dir, name))
            moved += 1
    val = os.path.join(out_root, "msls", "val")
    test = os.path.join(out_root, "msls", "test")
    if os.path.exists(val) and not os.path.exists(test):
        os.symlink(os.path.abspath(val), test)
    return moved


def format_tokyo247(raw_root: str, out_root: str) -> int:
    """Tokyo 24/7 -> images/test/{database,queries}
    (format_tokyo247.py:55-116): database from tokyo247.mat dbStruct (UTM
    zone 54S, pano = first 22 chars, tile = view index // 30), queries from
    the 247query_subset_v2 folder's per-image CSVs, resized to height 480.
    Queries archive must already be extracted under raw_root."""
    from PIL import Image
    from scipy.io import loadmat

    m = loadmat(os.path.join(raw_root, "datasets", "tokyo247.mat"))
    st = m["dbStruct"].item()
    db_images = [str(f[0].item()).replace(".jpg", ".png") for f in st[1]]
    db_utms = st[2].T
    dst_db = os.path.join(out_root, "images", "test", "database")
    os.makedirs(dst_db, exist_ok=True)
    done = 0
    for rel, (e, n) in zip(db_images, db_utms):
        base = os.path.basename(rel)
        lat, lon = utm_to_latlon(float(e), float(n), 54, "S")
        tile = int(re.findall(r"_012_(\d+)\.png", base)[0]) // 30
        if not 0 <= tile < 12:
            raise ValueError(f"{base}: tile {tile} outside 0..11")
        name = get_dst_image_name(lat, lon, base[:22], tile_num=tile)
        Image.open(os.path.join(raw_root, "tokyo247", rel)).convert(
            "RGB"
        ).save(os.path.join(dst_db, name))
        done += 1
    q_dir = os.path.join(raw_root, "tokyo247", "247query_subset_v2")
    dst_q = os.path.join(out_root, "images", "test", "queries")
    os.makedirs(dst_q, exist_ok=True)
    for src in sorted(glob.glob(os.path.join(q_dir, "*.jpg"))):
        with open(src.replace(".jpg", ".csv")) as f:
            pano_id, lat, lon = f.readline().split(",")[:3]
        # the ",jpg" (not ".jpg") replace mirrors format_tokyo247.py:104
        # verbatim — it is a no-op there too (pano_id comes from
        # split(",")[0]); kept for reference-exact naming, do not "fix"
        name = get_dst_image_name(lat, lon, pano_id.replace(",jpg", ""))
        img = Image.open(src)
        w, h = img.size
        scale = 480 / min(w, h)   # torchvision Resize(480): short edge
        img.resize((round(w * scale), round(h * scale)), Image.BILINEAR).save(
            os.path.join(dst_q, name)
        )
        done += 1
    return done


def format_pitts250k(raw_root: str, out_root: str) -> int:
    """pitts250k -> images/{train,val,test}/{database,queries}
    (format_pitts250k.py): per-split NetVLAD .mat structs; UTM zone 17T;
    tile = (pitch-1)*24 + (yaw-1) parsed from the filename."""
    from scipy.io import loadmat

    done = 0
    for split in ("train", "val", "test"):
        mat = os.path.join(raw_root, "datasets", f"pitts250k_{split}.mat")
        st = loadmat(mat)["dbStruct"].item()
        groups = (
            ("database", [str(f[0].item()) for f in st[1]], st[2].T),
            ("queries",
             [os.path.join("queries_real", str(f[0].item())) for f in st[3]],
             st[4].T),
        )
        for sub, fns, utms in groups:
            dst_dir = os.path.join(out_root, "images", split, sub)
            os.makedirs(dst_dir, exist_ok=True)
            for rel, (e, n) in zip(fns, utms):
                base = os.path.basename(rel)
                lat, lon = utm_to_latlon(float(e), float(n), 17, "T")
                pitch = int(re.findall(r"pitch(\d+)_", base)[0]) - 1
                yaw = int(re.findall(r"yaw(\d+)\.", base)[0]) - 1
                note = re.findall(r"_(.+)\.jpg", base)[0]
                name = get_dst_image_name(
                    lat, lon, base.split("_")[0],
                    tile_num=pitch * 24 + yaw, note=note,
                )
                shutil.copy2(os.path.join(raw_root, rel),
                             os.path.join(dst_dir, name))
                done += 1
    return done


def utm_to_latlon(easting: float, northing: float, zone: int,
                  letter: str) -> Tuple[float, float]:
    """UTM -> WGS84 inverse of ``latlon_to_utm`` (standard series)."""
    a = 6378137.0
    f = 1 / 298.257223563
    k0 = 0.9996
    e2 = f * (2 - f)
    ep2 = e2 / (1 - e2)
    x = easting - 500000.0
    y = northing
    if letter < "N":
        y -= 10000000.0
    m = y / k0
    mu = m / (a * (1 - e2 / 4 - 3 * e2 ** 2 / 64 - 5 * e2 ** 3 / 256))
    e1 = (1 - math.sqrt(1 - e2)) / (1 + math.sqrt(1 - e2))
    phi1 = mu + (
        (3 * e1 / 2 - 27 * e1 ** 3 / 32) * math.sin(2 * mu)
        + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * math.sin(4 * mu)
        + (151 * e1 ** 3 / 96) * math.sin(6 * mu)
        + (1097 * e1 ** 4 / 512) * math.sin(8 * mu)
    )
    n1 = a / math.sqrt(1 - e2 * math.sin(phi1) ** 2)
    t1 = math.tan(phi1) ** 2
    c1 = ep2 * math.cos(phi1) ** 2
    r1 = a * (1 - e2) / (1 - e2 * math.sin(phi1) ** 2) ** 1.5
    d = x / (n1 * k0)
    lat = phi1 - (n1 * math.tan(phi1) / r1) * (
        d ** 2 / 2
        - (5 + 3 * t1 + 10 * c1 - 4 * c1 ** 2 - 9 * ep2) * d ** 4 / 24
        + (61 + 90 * t1 + 298 * c1 + 45 * t1 ** 2 - 252 * ep2
           - 3 * c1 ** 2) * d ** 6 / 720
    )
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)
    lon = lon0 + (
        d - (1 + 2 * t1 + c1) * d ** 3 / 6
        + (5 - 2 * c1 + 28 * t1 - 3 * c1 ** 2 + 8 * ep2 + 24 * t1 ** 2)
        * d ** 5 / 120
    ) / math.cos(phi1)
    return math.degrees(lat), math.degrees(lon)
