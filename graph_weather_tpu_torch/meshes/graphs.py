"""Static graph bundles: the contract between host precompute and GPU compute.

NumPy copy of graph_weather_tpu/meshes/graphs.py; tests/test_torch_meshes.py
holds the two bit-identical. The reference builds PyG `Data` objects with Python loops over every grid
point at model construction (reference models/layers/encoder.py:76-107,
models/layers/assimilator_decoder.py:89-106) and then tiles edge indices per
batch sample at every forward (encoder.py:210-218). Here graph topology is a
frozen, destination-sorted COO array set produced once on the host with
vectorized NumPy; batching shares the static indices across the batch, so no edge
tiling ever happens on device.

Destination-sorting gives every receiver a contiguous run of edges, which
the padded-CSR aggregation (ops/scatter.py) relies on.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from graph_weather_tpu_torch.meshes.hexmesh import HexMesh, get_hexmesh
from graph_weather_tpu_torch.meshes.spherical import great_circle_distance_xyz, latlon_to_xyz


@dataclass(frozen=True)
class GraphBundle:
    """A static (possibly bipartite) graph as destination-sorted arrays.

    Attributes:
        senders: [E] int32 indices into the source node set.
        receivers: [E] int32 indices into the destination node set,
            non-decreasing (edges are destination-sorted).
        edge_attr: [E, D] float32 precomputed edge features.
        n_senders: size of the source node set.
        n_receivers: size of the destination node set.
    """

    senders: np.ndarray
    receivers: np.ndarray
    edge_attr: np.ndarray
    n_senders: int
    n_receivers: int

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    def sorted_by_receiver(self) -> "GraphBundle":
        order = np.argsort(self.receivers, kind="stable")
        return replace(
            self,
            senders=self.senders[order],
            receivers=self.receivers[order],
            edge_attr=self.edge_attr[order],
        )

    def device_arrays(self, device="cuda"):
        """Return (senders, receivers, edge_attr) as tensors on `device`:
        int32 indices and float32 edge features."""
        import torch

        return (
            torch.as_tensor(self.senders, dtype=torch.int32, device=device),
            torch.as_tensor(self.receivers, dtype=torch.int32, device=device),
            torch.as_tensor(self.edge_attr, dtype=torch.float32, device=device),
        )


def _sincos_dist(d: np.ndarray) -> np.ndarray:
    return np.stack([np.sin(d), np.cos(d)], axis=-1).astype(np.float32)


def build_grid_to_mesh_graph(
    lat_lons: np.ndarray, mesh: HexMesh | None = None, resolution: int = 2
) -> GraphBundle:
    """Bipartite grid->mesh graph: one edge per grid point to its cell.

    Edge attr is [sin(d), cos(d)] of the great-circle distance between the
    point and its containing cell's center, matching the reference encoder's
    graph (reference models/layers/encoder.py:85-107).
    """
    mesh = mesh if mesh is not None else get_hexmesh(resolution)
    lat_lons = np.asarray(lat_lons, dtype=np.float64)
    pts = latlon_to_xyz(lat_lons[:, 0], lat_lons[:, 1])
    cells = mesh.latlng_to_cell(lat_lons[:, 0], lat_lons[:, 1])
    dist = great_circle_distance_xyz(pts, mesh.cell_xyz[cells])
    bundle = GraphBundle(
        senders=np.arange(len(lat_lons), dtype=np.int32),
        receivers=cells.astype(np.int32),
        edge_attr=_sincos_dist(dist),
        n_senders=len(lat_lons),
        n_receivers=mesh.num_cells,
    )
    return bundle.sorted_by_receiver()


def build_latent_graph(mesh: HexMesh | None = None, resolution: int = 2) -> GraphBundle:
    """Mesh self+1-ring graph: cell -> each cell in its grid_disk(.., 1).

    Includes self-loops, matching `Encoder.create_latent_graph` (reference
    models/layers/encoder.py:244-268): 41,162 edges at resolution 2. Edge
    attr is [sin(d), cos(d)] of center-to-center distance (self-loops get
    [0, 1]).
    """
    mesh = mesh if mesh is not None else get_hexmesh(resolution)
    disks, mask = mesh.grid_disks(np.arange(mesh.num_cells))  # [N, 7]
    src = np.repeat(np.arange(mesh.num_cells, dtype=np.int32), 7)[mask.ravel()]
    dst = disks.ravel()[mask.ravel()].astype(np.int32)
    dist = great_circle_distance_xyz(mesh.cell_xyz[src], mesh.cell_xyz[dst])
    bundle = GraphBundle(
        senders=src,
        receivers=dst,
        edge_attr=_sincos_dist(dist),
        n_senders=mesh.num_cells,
        n_receivers=mesh.num_cells,
    )
    return bundle.sorted_by_receiver()


def build_mesh_to_grid_graph(
    lat_lons: np.ndarray, mesh: HexMesh | None = None, resolution: int = 2
) -> GraphBundle:
    """Bipartite mesh->grid graph: each point receives from its cell's disk.

    For every grid point, edges arrive from every cell in
    grid_disk(containing_cell, 1) — up to 7 senders per point (6 at
    pentagons), matching `AssimilatorDecoder.__init__` (reference
    models/layers/assimilator_decoder.py:89-106). Edge attr is
    [sin(d), cos(d)] of the distance from the grid point to each sender
    cell's center.
    """
    mesh = mesh if mesh is not None else get_hexmesh(resolution)
    lat_lons = np.asarray(lat_lons, dtype=np.float64)
    pts = latlon_to_xyz(lat_lons[:, 0], lat_lons[:, 1])
    cells = mesh.latlng_to_cell(lat_lons[:, 0], lat_lons[:, 1])
    disks, mask = mesh.grid_disks(cells)  # [P, 7]
    flat_mask = mask.ravel()
    src = disks.ravel()[flat_mask].astype(np.int32)
    dst = np.repeat(np.arange(len(lat_lons), dtype=np.int32), 7)[flat_mask]
    dist = great_circle_distance_xyz(pts[dst], mesh.cell_xyz[src])
    bundle = GraphBundle(
        senders=src,
        receivers=dst,
        edge_attr=_sincos_dist(dist),
        n_senders=mesh.num_cells,
        n_receivers=len(lat_lons),
    )
    return bundle.sorted_by_receiver()
