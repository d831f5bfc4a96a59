"""Static HTML dashboard rendering (the port of
``deeplearning4j_tpu/ui/render.py``: the same HTML from the same records;
tensors are accepted where the reference takes arrays).

Parity target: the reference's train UI pages (overview: score vs
iteration, update:param ratios, performance; model: per-layer histograms —
deeplearning4j-ui rendering of StatsStorage).  Zero-egress inversion: a
single self-contained HTML file with inline SVG charts, no external
scripts; re-render (or use UIServer) for live-ish updates.
"""

from __future__ import annotations

import html
import math
from typing import Dict, List, Optional, Sequence, Tuple


def _host(a):
    """A tensor (on any device) as a numpy array; anything else as it is."""
    if hasattr(a, "detach") and hasattr(a, "cpu"):
        return a.detach().cpu().numpy()
    return a


def _polyline(xs: Sequence[float], ys: Sequence[float], w: int = 560,
              h: int = 180, color: str = "#2563eb", logy: bool = False) -> str:
    if not xs or not ys:
        return "<svg/>"
    yv = [(math.log10(max(v, 1e-12)) if logy else v) for v in ys]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(yv), max(yv)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0
    pts = " ".join(
        f"{10 + (x - x0) / xr * (w - 20):.1f},{h - 15 - (y - y0) / yr * (h - 30):.1f}"
        for x, y in zip(xs, yv))
    lab_top = f"{(10 ** y1 if logy else y1):.4g}"
    lab_bot = f"{(10 ** y0 if logy else y0):.4g}"
    return (f'<svg width="{w}" height="{h}" style="background:#fafafa;'
            f'border:1px solid #ddd">'
            f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{pts}"/>'
            f'<text x="4" y="12" font-size="10" fill="#666">{lab_top}</text>'
            f'<text x="4" y="{h - 4}" font-size="10" fill="#666">{lab_bot}</text>'
            f'</svg>')


def _histogram_svg(hist: List[int], edges: List[float], w: int = 260,
                   h: int = 90, color: str = "#059669") -> str:
    if not hist:
        return "<svg/>"
    mx = max(hist) or 1
    n = len(hist)
    bw = (w - 20) / n
    bars = "".join(
        f'<rect x="{10 + i * bw:.1f}" y="{h - 12 - v / mx * (h - 24):.1f}" '
        f'width="{max(bw - 1, 1):.1f}" height="{v / mx * (h - 24):.1f}" '
        f'fill="{color}"/>' for i, v in enumerate(hist))
    return (f'<svg width="{w}" height="{h}" style="background:#fafafa;'
            f'border:1px solid #ddd">{bars}'
            f'<text x="4" y="{h - 2}" font-size="9" fill="#666">{edges[0]:.3g}</text>'
            f'<text x="{w - 40}" y="{h - 2}" font-size="9" fill="#666">{edges[1]:.3g}</text>'
            f'</svg>')


def render_session_html(storage, session_id: str) -> str:
    updates = [u for u in storage.get_updates(session_id) if "score" in u]
    if not updates:
        return (f"<html><body><h2>{html.escape(session_id)}</h2>"
                "<p>no updates recorded</p></body></html>")
    its = [u["iteration"] for u in updates]
    scores = [u["score"] for u in updates]
    rates = [(u["iteration"], u["iterations_per_sec"]) for u in updates
             if "iterations_per_sec" in u]
    mems = [(u["iteration"], u["memory"]["bytes_in_use"] / 2**20)
            for u in updates if "memory" in u]
    last = updates[-1]

    parts = [
        "<html><head><meta charset='utf-8'><title>deeplearning4j_tpu — ",
        html.escape(session_id),
        "</title><style>body{font-family:sans-serif;margin:20px;color:#111}"
        "h2{margin:18px 0 6px}table{border-collapse:collapse;font-size:12px}"
        "td,th{border:1px solid #ccc;padding:3px 8px;text-align:right}"
        "th{background:#f3f4f6}.grid{display:flex;flex-wrap:wrap;gap:14px}"
        ".card{font-size:11px;color:#444}</style></head><body>",
        f"<h1>Training session: {html.escape(session_id)}</h1>",
        f"<p>{len(updates)} updates · final score {scores[-1]:.5f}</p>",
        "<h2>Score vs iteration (log)</h2>", _polyline(its, scores, logy=True),
    ]
    if rates:
        parts += ["<h2>Iterations / sec</h2>",
                  _polyline([r[0] for r in rates], [r[1] for r in rates],
                            color="#d97706")]
    if mems:
        parts += ["<h2>Device memory in use (MB)</h2>",
                  _polyline([m[0] for m in mems], [m[1] for m in mems],
                            color="#dc2626")]

    ratios = last.get("update_ratios", {})
    if ratios:
        series: Dict[str, Tuple[List[float], List[float]]] = {}
        for u in updates:
            for pid, r in u.get("update_ratios", {}).items():
                series.setdefault(pid, ([], []))
                series[pid][0].append(u["iteration"])
                series[pid][1].append(max(r, 1e-12))
        parts.append("<h2>Update : parameter mean-magnitude ratio (log; "
                     "healthy ≈ 1e-3)</h2><div class='grid'>")
        for pid, (xs, ys) in sorted(series.items()):
            parts.append(f"<div class='card'>{html.escape(pid)}<br>"
                         + _polyline(xs, ys, w=260, h=90, color="#7c3aed",
                                     logy=True) + "</div>")
        parts.append("</div>")

    pstats = last.get("parameters", {})
    if pstats:
        parts.append("<h2>Parameter stats (last iteration)</h2><table>"
                     "<tr><th>param</th><th>mean</th><th>std</th><th>min</th>"
                     "<th>max</th></tr>")
        for pid, st in sorted(pstats.items()):
            if st:
                parts.append(
                    f"<tr><td style='text-align:left'>{html.escape(pid)}</td>"
                    f"<td>{st['mean']:.4g}</td><td>{st['std']:.4g}</td>"
                    f"<td>{st['min']:.4g}</td><td>{st['max']:.4g}</td></tr>")
        parts.append("</table>")
        hists = [(pid, st) for pid, st in sorted(pstats.items())
                 if st.get("histogram")]
        if hists:
            parts.append("<h2>Parameter histograms (last iteration)</h2>"
                         "<div class='grid'>")
            for pid, st in hists:
                parts.append(f"<div class='card'>{html.escape(pid)}<br>"
                             + _histogram_svg(st["histogram"],
                                              st["histogram_edges"]) + "</div>")
            parts.append("</div>")
    parts.append("</body></html>")
    return "".join(parts)


def render_dashboard(storage, path: str,
                     session_id: Optional[str] = None) -> str:
    """Write a self-contained HTML report for one session (default: the
    latest) and return the path."""
    sessions = storage.list_session_ids()
    if not sessions:
        raise ValueError("storage has no sessions")
    sid = session_id or sessions[-1]
    html_text = render_session_html(storage, sid)
    with open(path, "w") as f:
        f.write(html_text)
    return path


def render_embedding_html(coords, labels=None, words: Optional[Sequence[str]] = None,
                          title: str = "t-SNE embedding",
                          w: int = 720, h: int = 720) -> str:
    """Self-contained scatter page for 2-D embeddings — the reference UI's
    t-SNE viewer (deeplearning4j-play TsneModule: upload coords, render a
    point cloud).  ``coords`` [N,2]; ``labels`` optional int classes
    (colors); ``words`` optional hover/annotation strings (first 200 get
    text annotations, all get <title> hovers)."""
    import numpy as np

    c = np.asarray(_host(coords), float)
    if c.ndim != 2 or c.shape[1] != 2:
        raise ValueError(f"coords must be [N,2], got {c.shape}")
    n = len(c)
    if words is not None and len(words) != n:
        raise ValueError(f"{len(words)} words for {n} points")
    if n == 0:
        return ("<!doctype html><html><body style='font-family:system-ui'>"
                f"<h2>{html.escape(title)}</h2><p>0 points</p></body></html>")
    x0, y0 = c.min(axis=0)
    x1, y1 = c.max(axis=0)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0
    palette = ["#2563eb", "#dc2626", "#059669", "#d97706", "#7c3aed",
               "#0891b2", "#be185d", "#4d7c0f", "#b45309", "#1e40af"]
    lab = None if labels is None else np.asarray(_host(labels))
    pts = []
    for i in range(n):
        px = 20 + (c[i, 0] - x0) / xr * (w - 40)
        py = h - 20 - (c[i, 1] - y0) / yr * (h - 40)
        color = palette[int(lab[i]) % len(palette)] if lab is not None \
            else "#2563eb"
        tip = html.escape(str(words[i])) if words is not None else str(i)
        pts.append(f'<circle cx="{px:.1f}" cy="{py:.1f}" r="2.5" '
                   f'fill="{color}" fill-opacity="0.7"><title>{tip}</title>'
                   f'</circle>')
        if words is not None and i < 200:
            pts.append(f'<text x="{px + 3:.1f}" y="{py - 3:.1f}" '
                       f'font-size="8" fill="#444">{html.escape(str(words[i]))}'
                       f'</text>')
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title></head><body "
            "style='font-family:system-ui;margin:16px'>"
            f"<h2>{html.escape(title)}</h2><p>{n} points</p>"
            f'<svg width="{w}" height="{h}" style="background:#fafafa;'
            f'border:1px solid #ddd">{"".join(pts)}</svg></body></html>')
