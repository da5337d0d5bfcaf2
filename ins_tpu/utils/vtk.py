"""Minimal VTK XML writers (RectilinearGrid .vtr + ParaView .pvd).

Replacement for the reference's WriteVTK.jl path
(IncompressibleNavierStokes.jl src/processors.jl:204-285). No VTK library
dependency: the .vtr format is plain XML with base64-encoded binary
appended data.
"""

from __future__ import annotations

import os

import numpy as np

from .native import AsyncWriter, b64_vtk as _b64_data

__all__ = ["write_vtr", "PVDCollection", "AsyncWriter"]


def write_vtr(filename, coords, pointdata, *, time=None, writer=None):
    """Write a rectilinear-grid VTK file.

    - `coords`: tuple of 1-D coordinate arrays (2 or 3 of them; 2D grids
      get a zero z-coordinate).
    - `pointdata`: dict name -> array. Scalars have the grid shape; vector
      fields have shape (D, *grid) (2D vectors are padded with a zero
      z-component, as ParaView prefers).
    """
    coords = [np.asarray(c, dtype=np.float32) for c in coords]
    while len(coords) < 3:
        coords.append(np.zeros(1, np.float32))
    nx, ny, nz = (len(c) for c in coords)
    extent = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"

    if not filename.endswith(".vtr"):
        filename = filename + ".vtr"
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)

    parts = []
    parts.append('<?xml version="1.0"?>')
    parts.append(
        '<VTKFile type="RectilinearGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt32">'
    )
    parts.append(f'<RectilinearGrid WholeExtent="{extent}">')
    if time is not None:
        parts.append('<FieldData>')
        parts.append(
            '<DataArray type="Float32" Name="TimeValue" '
            'NumberOfTuples="1" format="binary">'
            + _b64_data(np.asarray([time], np.float32))
            + "</DataArray>"
        )
        parts.append("</FieldData>")
    parts.append(f'<Piece Extent="{extent}">')
    parts.append("<Coordinates>")
    for i, c in enumerate(coords):
        parts.append(
            f'<DataArray type="Float32" Name="coord{i}" format="binary">'
            + _b64_data(c)
            + "</DataArray>"
        )
    parts.append("</Coordinates>")
    parts.append("<PointData>")
    for name, arr in pointdata.items():
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim in (2, 3) and arr.shape[0] not in (2, 3):
            # Scalar field on the grid
            flat = arr.reshape(-1, order="F")
            parts.append(
                f'<DataArray type="Float32" Name="{name}" format="binary">'
                + _b64_data(flat)
                + "</DataArray>"
            )
        else:
            # Vector field (D, *grid): pad to 3 components, interleave
            D = arr.shape[0]
            comps = [arr[i].reshape(-1, order="F") for i in range(D)]
            while len(comps) < 3:
                comps.append(np.zeros_like(comps[0]))
            inter = np.stack(comps, axis=-1).reshape(-1)
            parts.append(
                f'<DataArray type="Float32" Name="{name}" '
                'NumberOfComponents="3" format="binary">'
                + _b64_data(inter)
                + "</DataArray>"
            )
    parts.append("</PointData>")
    parts.append("</Piece>")
    parts.append("</RectilinearGrid>")
    parts.append("</VTKFile>")
    payload = "\n".join(parts).encode()
    if writer is not None:
        # Non-blocking: the native threaded writer owns the disk I/O
        writer.submit(filename, payload)
    else:
        with open(filename, "wb") as f:
            f.write(payload)
    return filename


class PVDCollection:
    """ParaView data collection (.pvd) over time-stamped .vtr files."""

    def __init__(self, filename):
        if not filename.endswith(".pvd"):
            filename = filename + ".pvd"
        self.filename = filename
        self.entries = []

    def add(self, t, vtrfile):
        self.entries.append((float(t), os.path.basename(vtrfile)))

    def save(self):
        os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="1.0" byte_order="LittleEndian">',
            "<Collection>",
        ]
        for t, f in self.entries:
            lines.append(f'<DataSet timestep="{t}" part="0" file="{f}"/>')
        lines += ["</Collection>", "</VTKFile>"]
        with open(self.filename, "w") as f:
            f.write("\n".join(lines))
        return self.filename
