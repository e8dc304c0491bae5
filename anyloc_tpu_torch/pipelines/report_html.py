"""Self-contained HTML report — the app surface replacing the reference's
interactive demos (demo/gradio_imgs_vlad_clusters.py:1-315 cluster-overlay
app, demo/hf_imgs_vlad_clusters.py:116-420 GeM t-SNE domain picker). A
copy of ``anyloc_tpu/pipelines/report_html.py`` (numpy and the standard
library only).

One command (``viz_cli report``) turns a directory of images into ONE .html
file with the same interactions the gradio app offers, client-side and
dependency-free: per-pixel VLAD cluster overlays rendered on <canvas> from
the embedded patch-assignment grids, a blend-alpha slider, per-cluster
toggles, click-a-patch-to-isolate-its-cluster, plus (optionally) the domain
t-SNE scatter with hover tooltips. Open the file in any browser, or serve it
with ``--serve`` (stdlib http.server).
"""

from __future__ import annotations

import base64
import html
import io
import json
from typing import Dict, List, Optional

import numpy as np

# Scatter series colors: the first three slots of the validated reference
# categorical palette (dataviz method; all-pairs-safe cap for scatter forms).
# User images use ink + marker shape, not a fourth hue.
_DOMAIN_COLORS_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a"]
_DOMAIN_COLORS_DARK = ["#3987e5", "#d95926", "#199e70"]

# scatter series hues as CSS variables so dark mode swaps point fills too
_PALETTE_CSS = (
    ".viz-root { "
    + " ".join(f"--cat-{i + 1}:{c};" for i, c in enumerate(_DOMAIN_COLORS_LIGHT))
    + " }\n@media (prefers-color-scheme: dark) { .viz-root { "
    + " ".join(f"--cat-{i + 1}:{c};" for i, c in enumerate(_DOMAIN_COLORS_DARK))
    + " } }\n"
)

_CSS = _PALETTE_CSS + """
.viz-root { color-scheme: light;
  --surface-1:#fcfcfb; --surface-2:#f1f0ee; --text-primary:#0b0b0b;
  --text-secondary:#52514e; --border:#d9d8d4; }
@media (prefers-color-scheme: dark) {
  .viz-root { color-scheme: dark;
    --surface-1:#1a1a19; --surface-2:#242423; --text-primary:#ffffff;
    --text-secondary:#c3c2b7; --border:#3a3a38; } }
body { margin:0; }
.viz-root { background:var(--surface-1); color:var(--text-primary);
  font:14px/1.5 system-ui, sans-serif; padding:24px; min-height:100vh; }
h1 { font-size:20px; margin:0 0 4px; }
h2 { font-size:16px; margin:28px 0 8px; }
.sub { color:var(--text-secondary); margin:0 0 16px; }
.controls { display:flex; gap:16px; align-items:center; flex-wrap:wrap;
  padding:10px 12px; background:var(--surface-2); border-radius:8px;
  border:1px solid var(--border); margin-bottom:16px; }
.controls label { color:var(--text-secondary); }
.chips { display:flex; gap:6px; flex-wrap:wrap; }
.chip { display:inline-flex; align-items:center; gap:5px; padding:2px 8px;
  border:1px solid var(--border); border-radius:999px; cursor:pointer;
  user-select:none; color:var(--text-secondary); }
.chip.off { opacity:0.35; }
.chip .sw { width:10px; height:10px; border-radius:2px; display:inline-block; }
.cards { display:flex; flex-wrap:wrap; gap:16px; }
.card { background:var(--surface-2); border:1px solid var(--border);
  border-radius:8px; padding:10px; }
.card .name { color:var(--text-secondary); font-size:12px; margin-top:6px; }
canvas.overlay { border-radius:4px; cursor:crosshair; display:block;
  max-width:100%; }
.scatterwrap { position:relative; display:inline-block; }
.tooltip { position:absolute; pointer-events:none; background:var(--surface-2);
  border:1px solid var(--border); color:var(--text-primary); padding:3px 8px;
  border-radius:6px; font-size:12px; display:none; white-space:nowrap; }
.legend { display:flex; gap:14px; margin:8px 0; color:var(--text-secondary);
  font-size:13px; flex-wrap:wrap; }
.legend .sw { width:10px; height:10px; border-radius:5px;
  display:inline-block; margin-right:5px; }
"""

_JS = """
const DATA = JSON.parse(document.getElementById('viz-data').textContent);
const state = { alpha: 0.5, on: DATA.palette.map(() => true) };

function drawAll() {
  DATA.images.forEach((im, i) => draw(i));
}
function draw(i) {
  const im = DATA.images[i];
  const cv = document.getElementById('cv' + i);
  const ctx = cv.getContext('2d');
  const img = document.getElementById('img' + i);
  ctx.clearRect(0, 0, cv.width, cv.height);
  ctx.drawImage(img, 0, 0, cv.width, cv.height);
  const [gh, gw] = im.grid;
  const cw = cv.width / gw, ch = cv.height / gh;
  ctx.globalAlpha = state.alpha;
  for (let y = 0; y < gh; y++) for (let x = 0; x < gw; x++) {
    const c = im.labels[y * gw + x];
    if (!state.on[c]) continue;
    ctx.fillStyle = DATA.palette[c];
    ctx.fillRect(x * cw, y * ch, Math.ceil(cw), Math.ceil(ch));
  }
  ctx.globalAlpha = 1.0;
}
function setupClusterUI() {
  const chips = document.getElementById('chips');
  DATA.palette.forEach((hex, c) => {
    const el = document.createElement('span');
    el.className = 'chip';
    el.innerHTML = `<span class="sw" style="background:${hex}"></span>c${c}`;
    el.onclick = () => { state.on[c] = !state.on[c];
      el.classList.toggle('off', !state.on[c]); drawAll(); };
    chips.appendChild(el);
  });
  const slider = document.getElementById('alpha');
  slider.oninput = () => {
    state.alpha = slider.value / 100;
    document.getElementById('alphaval').textContent = state.alpha.toFixed(2);
    drawAll();
  };
  document.getElementById('only').onclick = () => {
    const any = state.on.some(v => !v);
    state.on = state.on.map(() => any);
    document.querySelectorAll('.chip').forEach(
      (el, c) => el.classList.toggle('off', !state.on[c]));
    drawAll();
  };
  DATA.images.forEach((im, i) => {
    const cv = document.getElementById('cv' + i);
    cv.onclick = (ev) => {  // pixel pick -> isolate that patch's cluster
      const r = cv.getBoundingClientRect();
      const [gh, gw] = im.grid;
      // clamp: a click on the exact right/bottom edge yields fraction 1.0
      const x = Math.min(gw - 1, Math.floor((ev.clientX - r.left) / r.width * gw));
      const y = Math.min(gh - 1, Math.floor((ev.clientY - r.top) / r.height * gh));
      const c = im.labels[y * gw + x];
      state.on[c] = !state.on[c];
      document.querySelectorAll('.chip')[c].classList.toggle('off', !state.on[c]);
      drawAll();
    };
  });
}
function setupScatterTooltip() {
  const wrap = document.querySelector('.scatterwrap');
  if (!wrap) return;
  const tip = wrap.querySelector('.tooltip');
  wrap.querySelectorAll('[data-name]').forEach(el => {
    el.addEventListener('mousemove', ev => {
      tip.style.display = 'block';
      tip.textContent = el.dataset.name;
      const r = wrap.getBoundingClientRect();
      tip.style.left = (ev.clientX - r.left + 12) + 'px';
      tip.style.top = (ev.clientY - r.top - 8) + 'px';
    });
    el.addEventListener('mouseleave', () => tip.style.display = 'none');
  });
}
window.addEventListener('load', () => {
  setupClusterUI(); drawAll(); setupScatterTooltip();
});
"""


def _b64_jpeg(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=85)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _scatter_svg(points: List[dict], colors: Dict[str, str],
                 width: int = 640, height: int = 440) -> str:
    """Domain-projection scatter: datasets colored by domain (first three
    validated categorical slots), user images as ink-ring markers — identity
    never rides on a fourth hue. Hover handled by the shared JS tooltip."""
    xs = np.array([p["x"] for p in points])
    ys = np.array([p["y"] for p in points])
    pad = 28
    sx = lambda x: pad + (x - xs.min()) / max(float(np.ptp(xs)), 1e-9) * (width - 2 * pad)   # noqa: E731
    sy = lambda y: height - pad - (y - ys.min()) / max(float(np.ptp(ys)), 1e-9) * (height - 2 * pad)  # noqa: E731
    marks = []
    for p in points:
        x, y = sx(p["x"]), sy(p["y"])
        name = html.escape(p["name"], quote=True)
        if p.get("user"):
            # 2px surface ring on the overlapping mark class (mark spec)
            marks.append(
                f'<circle cx="{x:.1f}" cy="{y:.1f}" r="6" fill="none" '
                f'stroke="var(--text-primary)" stroke-width="2" '
                f'data-name="{name} (yours)"/>'
            )
        else:
            c = colors.get(p["domain"], "var(--text-secondary)")
            marks.append(
                f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4.5" fill="{c}" '
                f'stroke="var(--surface-1)" stroke-width="1" '
                f'data-name="{name}"/>'
            )
    return (
        f'<svg width="{width}" height="{height}" role="img" '
        f'aria-label="GeM t-SNE domain projection">'
        f'<rect width="{width}" height="{height}" fill="var(--surface-2)" rx="8"/>'
        + "".join(marks) + "</svg>"
    )


def build_report(
    images: List[dict],      # {name, rgb [H,W,3] u8, grid (gh,gw), labels [N]}
    cluster_palette: np.ndarray,   # [C, 3] uint8
    domain_points: Optional[List[dict]] = None,  # {name, domain, x, y, user}
    title: str = "AnyLoc-TPU cluster report",
    config_line: str = "",
) -> str:
    pal_hex = ["#%02x%02x%02x" % tuple(c) for c in cluster_palette]
    data = {
        "palette": pal_hex,
        "images": [
            {"grid": list(im["grid"]), "labels": [int(v) for v in im["labels"]]}
            for im in images
        ],
    }
    cards = []
    for i, im in enumerate(images):
        h, w = im["rgb"].shape[:2]
        cards.append(
            f'<div class="card">'
            f'<img id="img{i}" src="data:image/jpeg;base64,{_b64_jpeg(im["rgb"])}" hidden>'
            f'<canvas id="cv{i}" class="overlay" width="{w}" height="{h}"></canvas>'
            f'<div class="name">{html.escape(im["name"])}</div></div>'
        )
    domain_html = ""
    if domain_points:
        domains = [d for d in dict.fromkeys(
            p["domain"] for p in domain_points if not p.get("user")
        )][:3]
        # var() indirection: the same SVG/swatch markup renders the light or
        # dark hue per prefers-color-scheme (values in _PALETTE_CSS)
        light = {d: f"var(--cat-{i + 1})" for i, d in enumerate(domains)}
        legend = "".join(
            f'<span><span class="sw" style="background:{light[d]}"></span>{d}</span>'
            for d in domains
        ) + ('<span><span class="sw" style="background:transparent;'
             'border:2px solid var(--text-primary)"></span>your images</span>')
        domain_html = (
            '<h2>Domain projection (GeM t-SNE)</h2>'
            '<p class="sub">Where your images land among the cached per-'
            'dataset GeM descriptors (hf_imgs_vlad_clusters.py domain picker). '
            'Hover a point for its dataset.</p>'
            f'<div class="legend">{legend}</div>'
            '<div class="scatterwrap">'
            + _scatter_svg(domain_points, light)
            + '<div class="tooltip"></div></div>'
        )
    esc_title = html.escape(title)
    return f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{esc_title}</title>
<style>{_CSS}</style></head>
<body><div class="viz-root">
<h1>{esc_title}</h1>
<p class="sub">{html.escape(config_line)}</p>
<h2>VLAD cluster assignments</h2>
<p class="sub">Per-patch hard assignments to the domain vocabulary
(gradio_imgs_vlad_clusters.py semantics). Drag alpha to blend; click a
cluster chip — or a patch in an image — to toggle that cluster.</p>
<div class="controls">
  <label>blend alpha <input type="range" id="alpha" min="0" max="100"
    value="50"> <span id="alphaval">0.50</span></label>
  <button id="only">toggle all</button>
  <span class="chips" id="chips"></span>
</div>
<div class="cards">{''.join(cards)}</div>
{domain_html}
<script type="application/json" id="viz-data">{json.dumps(data)}</script>
<script>{_JS}</script>
</div></body></html>"""
