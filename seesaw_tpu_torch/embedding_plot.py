"""Embedding explorer: 2D map of the database with clusters and queries.

Counterpart of `seesaw_tpu/embedding_plot.py`, on an explicit torch
device: the 2D projection is a PCA (the top two eigenvectors of the
centered (d, d) gram, `torch.linalg.eigh`, vectors normalized first so that
cosine geometry is kept), clusters come from `iters` Lloyd steps of k-means
from a seeded numpy choice of centers and a final assignment, a query's
top-k members are the same dot products the JAX package takes on the host,
and the output is the same self-contained interactive HTML canvas scatter
(pan/zoom/hover). The eigenvectors' signs are whatever `eigh` returns, as
in the JAX package: two packages' maps may be mirrored along an axis.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


def _normalize(X: np.ndarray) -> np.ndarray:
    X = np.asarray(X, np.float32)
    return X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)


def _pca2(X: torch.Tensor):
    mu = X.mean(dim=0)
    Xc = X - mu
    # top-2 right singular vectors via eigh of the (d, d) gram (d is small)
    _, V = torch.linalg.eigh(Xc.T @ Xc)
    P = V[:, -2:].flip(1)  # descending variance
    return Xc @ P, mu, P


def _sq_dists(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return ((X ** 2).sum(dim=1, keepdim=True) - 2.0 * X @ centers.T
            + (centers ** 2).sum(dim=1)[None, :])


def _kmeans(X: torch.Tensor, init_idx: torch.Tensor, *, k: int, iters: int = 25):
    """`iters` Lloyd steps from X[init_idx] (an empty cluster keeps its
    center), then the final assignment; argmin takes the first minimum."""
    centers = X[init_idx]
    for _ in range(iters):
        assign = _sq_dists(X, centers).argmin(dim=1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(X.dtype)  # (n, k)
        counts = one_hot.sum(dim=0)
        new_centers = (one_hot.T @ X) / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new_centers, centers)
    return _sq_dists(X, centers).argmin(dim=1), centers


class Visualizer:
    """Fit once, then write_html() a standalone explorer page."""

    def __init__(self, vectors: np.ndarray, dbidx: Optional[np.ndarray] = None, *,
                 device):
        self.device = torch.device(device)
        self.vectors = _normalize(vectors)
        self.dbidx = (
            np.asarray(dbidx, np.int64)
            if dbidx is not None
            else np.arange(len(self.vectors))
        )
        self.xy = None
        self.cluster_id = np.zeros(len(self.vectors), np.int32)
        self.queries: List[dict] = []
        self._mu = self._P = None

    def fit_projection(self) -> np.ndarray:
        xy, mu, P = _pca2(torch.from_numpy(self.vectors).to(self.device))
        self.xy, self._mu, self._P = (t.cpu().numpy() for t in (xy, mu, P))
        return self.xy

    def project(self, vecs: np.ndarray) -> np.ndarray:
        assert self._P is not None, "call fit_projection first"
        return (_normalize(vecs) - self._mu) @ self._P

    def assign_clusters(self, k: int = 12, iters: int = 25, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        init = rng.choice(len(self.vectors), size=k, replace=False)
        assign, _ = _kmeans(
            torch.from_numpy(self.vectors).to(self.device),
            torch.from_numpy(init).to(self.device), k=k, iters=iters,
        )
        self.cluster_id = assign.cpu().numpy().astype(np.int32)
        return self.cluster_id

    def add_query(self, name: str, qvec: np.ndarray, topk: int = 50):
        """Overlay a query: its projected location + its top-k member set."""
        q = _normalize(qvec.reshape(1, -1))[0]
        scores = self.vectors @ q
        top = np.argsort(-scores)[:topk]
        self.queries.append(
            dict(name=name, xy=self.project(q.reshape(1, -1))[0].tolist(),
                 top=self.dbidx[top].tolist())
        )

    def write_html(self, path: str, urls: Optional[List[str]] = None,
                   title: str = "embedding explorer") -> str:
        assert self.xy is not None, "call fit_projection first"
        data = dict(
            x=np.round(self.xy[:, 0], 4).tolist(),
            y=np.round(self.xy[:, 1], 4).tolist(),
            c=self.cluster_id.tolist(),
            dbidx=self.dbidx.tolist(),
            urls=urls,
            queries=self.queries,
        )
        html = _HTML_TEMPLATE.replace("__TITLE__", title).replace(
            "__DATA__", json.dumps(data)
        )
        Path(path).write_text(html)
        return path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"/><title>__TITLE__</title>
<style>
 body{margin:0;font-family:system-ui;background:#111;color:#eee}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;
      border-radius:6px;font-size:13px;pointer-events:none}
 canvas{display:block}
</style></head><body>
<div id="hud">__TITLE__ — scroll to zoom, drag to pan</div>
<canvas id="cv"></canvas>
<script>
const D = __DATA__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud');
const PALETTE = ['#4e79a7','#f28e2b','#e15759','#76b7b2','#59a14f','#edc948',
                 '#b07aa1','#ff9da7','#9c755f','#bab0ab','#86bcb6','#d37295'];
let W, H, scale, ox, oy;
function fit(){
  W = cv.width = window.innerWidth; H = cv.height = window.innerHeight;
  const xs = D.x, ys = D.y;
  const x0=Math.min(...xs), x1=Math.max(...xs), y0=Math.min(...ys), y1=Math.max(...ys);
  scale = 0.9 * Math.min(W/(x1-x0+1e-9), H/(y1-y0+1e-9));
  ox = W/2 - scale*(x0+x1)/2; oy = H/2 - scale*(y0+y1)/2;
  draw();
}
function sx(x){return x*scale+ox} function sy(y){return y*scale+oy}
function draw(){
  ctx.clearRect(0,0,W,H);
  for(let i=0;i<D.x.length;i++){
    ctx.fillStyle = PALETTE[D.c[i]%PALETTE.length];
    ctx.globalAlpha = 0.75;
    ctx.fillRect(sx(D.x[i])-1.5, sy(D.y[i])-1.5, 3, 3);
  }
  ctx.globalAlpha = 1;
  for(const q of (D.queries||[])){
    ctx.fillStyle = '#fff'; ctx.font = '13px system-ui';
    ctx.beginPath(); ctx.arc(sx(q.xy[0]), sy(q.xy[1]), 5, 0, 7); ctx.fill();
    ctx.fillText(q.name, sx(q.xy[0])+8, sy(q.xy[1])+4);
  }
}
let drag=null;
cv.onmousedown = e=>{drag=[e.clientX,e.clientY]};
window.onmouseup = ()=>{drag=null};
cv.onmousemove = e=>{
  if(drag){ox+=e.clientX-drag[0];oy+=e.clientY-drag[1];drag=[e.clientX,e.clientY];draw();return}
  let best=-1,bd=64;
  for(let i=0;i<D.x.length;i++){
    const dx=sx(D.x[i])-e.clientX, dy=sy(D.y[i])-e.clientY, d=dx*dx+dy*dy;
    if(d<bd){bd=d;best=i}
  }
  hud.textContent = best<0 ? '__TITLE__' :
    `#${D.dbidx[best]} cluster ${D.c[best]}` + (D.urls? ' '+D.urls[best] : '');
};
cv.onwheel = e=>{
  e.preventDefault();
  const f = e.deltaY<0 ? 1.15 : 1/1.15;
  ox = e.clientX-(e.clientX-ox)*f; oy = e.clientY-(e.clientY-oy)*f; scale*=f; draw();
};
window.onresize = fit; fit();
</script></body></html>
"""
