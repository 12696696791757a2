"""Rotating-GIF rendering of a reconstructed mesh — counterpart of
sdf_representation_tpu/evaluations/generate_gif.py (reference
evaluations/generate_gif.py:8-51: matplotlib trisurf, 10 frames over 360
degrees), with matplotlib and PIL, imported only when a GIF is drawn."""

from __future__ import annotations

import io
import sys

import numpy as np

from ..geometry.mesh_io import load_mesh


def plot_stl(stl_path: str, gif_path: str, frames: int = 10, dpi: int = 80) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    mesh = load_mesh(stl_path)
    v, f = mesh.vertices, mesh.faces
    # matplotlib trisurf takes minutes beyond ~50k triangles: the preview
    # draws a subsample (the STL keeps full resolution)
    max_tris = 50000
    if len(f) > max_tris:
        idx = np.random.default_rng(0).choice(len(f), max_tris, replace=False)
        f = f[idx]

    images = []
    for i in range(frames):
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot_trisurf(
            v[:, 0], v[:, 1], f, v[:, 2], cmap="viridis", edgecolor="none"
        )
        ax.view_init(elev=20, azim=360.0 * i / frames)
        ax.set_axis_off()
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=dpi)
        plt.close(fig)
        buf.seek(0)
        images.append(Image.open(buf).convert("P"))
    images[0].save(
        gif_path, save_all=True, append_images=images[1:], duration=200, loop=0
    )
    return gif_path


if __name__ == "__main__":
    plot_stl(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "out.gif")
