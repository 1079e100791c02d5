"""HTML experiment reports: image grids per experiment directory (the
port's copy of ``utils/html_report.py``).

Role of the reference's dominate-based generator
(``utils/generate_html.py:6-120``) without the dominate dependency — plain
string templating, one table row per iteration/experiment with thumbnails
linking to full images.
"""

from __future__ import annotations

import html
import os
from typing import Dict, List, Sequence

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #ccc; padding: 6px; text-align: center; }}
 img {{ display: block; }}
</style></head>
<body><h1>{title}</h1>
{tables}
</body></html>
"""


class HTMLReport:
    def __init__(self, out_dir: str, title: str = "experiment"):
        self.out_dir = out_dir
        self.title = title
        self._sections: List[str] = []

    def add_header(self, text: str):
        self._sections.append(f"<h2>{html.escape(text)}</h2>")

    def add_text(self, text: str):
        self._sections.append(f"<p>{html.escape(text)}</p>")

    def add_image_row(self, images: Sequence[str], labels: Sequence[str],
                      width: int = 256):
        """One table of images (paths relative to out_dir) with captions."""
        cells_img = "".join(
            f'<td><a href="{html.escape(p, quote=True)}">'
            f'<img src="{html.escape(p, quote=True)}" width="{width}">'
            f"</a></td>"
            for p in images)
        cells_lbl = "".join(f"<td>{html.escape(l)}</td>" for l in labels)
        self._sections.append(
            f"<table><tr>{cells_img}</tr><tr>{cells_lbl}</tr></table>")

    def add_metrics_table(self, rows: List[Dict]):
        if not rows:
            return
        keys = list(rows[0].keys())
        head = "".join(f"<th>{html.escape(str(k))}</th>" for k in keys)
        body = ""
        for r in rows:
            # Index by the header's keys (not r.values()) so heterogeneous
            # rows keep every cell under its own column.
            cells = "".join(
                f"<td>{html.escape(f'{v:.4f}' if isinstance(v, float) else str(v))}</td>"
                for v in (r.get(k, "") for k in keys))
            body += f"<tr>{cells}</tr>"
        self._sections.append(f"<table><tr>{head}</tr>{body}</table>")

    def save(self, filename: str = "index.html") -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, filename)
        with open(path, "w") as f:
            f.write(_PAGE.format(title=html.escape(self.title),
                                 tables="\n".join(self._sections)))
        return path


def report_from_renders(render_dir: str, title: str = "renders",
                        metrics: List[Dict] | None = None) -> str:
    """Build an index.html over the PNGs of a render directory."""
    pngs = [f for f in sorted(os.listdir(render_dir))
            if f.endswith(".png") and not f.endswith("_depth.png")]
    rep = HTMLReport(render_dir, title)
    if metrics:
        rep.add_header("metrics")
        rep.add_metrics_table(metrics)
    rep.add_header("renders")
    for p in pngs:
        depth = p.replace(".png", "_depth.png")
        row = [p] + ([depth] if os.path.exists(os.path.join(render_dir, depth))
                     else [])
        rep.add_image_row(row, row)
    return rep.save()
