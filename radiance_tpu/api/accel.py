"""Acceleration-structure build API (RD::BuildAccelStruct equivalents).

Reference: radiance/src/radiance.cpp:20-84 (BLAS/TLAS build wrappers),
radiance.cpp:428-479 (file round trip).  The host-side SAH build runs in
NumPy (or the C++ native builder when available); the device representation
is produced lazily.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from radiance_tpu import config
from radiance_tpu.bvh import builder, device, serialize
from radiance_tpu.core import types


def BuildBottomAccelStruct(mesh: types.Mesh, verbose: bool = False) -> types.BottomAccelStruct:
    """Build a BLAS from a mesh (reference: radiance.cpp:20-52)."""
    t0 = time.time()
    nodes, faces, max_depth = builder.build_blas_arrays(mesh.vertices, mesh.triangles)
    blob = serialize.serialize_blas(nodes, faces, mesh.vertices)
    if verbose:
        print(f"BLAS build: {len(mesh.triangles)} tris, {len(nodes)} nodes, "
              f"depth {max_depth}, {time.time() - t0:.3f}s")
    return types.BottomAccelStruct(
        data=blob,
        nodes=nodes,
        faces=faces,
        vertices=np.ascontiguousarray(mesh.vertices, np.float32),
        root_bottom=np.asarray(nodes[0]["bottom"], np.float32),
        root_top=np.asarray(nodes[0]["top"], np.float32),
    )


@dataclasses.dataclass
class TopAccelStruct:
    """Built TLAS: serialized blob + host arrays + lazy device scene.

    `blob` is a lazy property: refit() only invalidates it, because
    reserializing the full AS byte blob per animation frame would
    dominate a rigid-refit frame.  Reading .blob
    after a refit still reflects the refit state (checkpoint of
    animated scenes, tests/test_refit.py)."""
    _blob: Optional[bytes]
    nodes: np.ndarray               # DEVICE_BVH_NODE_DTYPE
    instances: np.ndarray           # DEVICE_INSTANCE_DTYPE (leaf order)
    blas_offsets: list              # [(offset, BottomAccelStruct)]
    source_instances: Optional[list] = None  # RD Instance list (refit path)
    tlas_capacity: int = 0
    _device: Optional[device.DeviceScene] = None
    _device_blas_order: Optional[list] = None  # BLAS objs in device layout order

    @property
    def blob(self) -> bytes:
        if self._blob is None:
            self._blob = serialize.serialize_tlas(
                self.nodes, self.instances, self.blas_offsets)
        return self._blob

    def device_scene(self) -> device.DeviceScene:
        if self._device is None:
            blas_by_offset = {
                off: (b.nodes, b.faces, b.vertices) for off, b in self.blas_offsets
            }
            self._device = device.build_device_scene(
                self.nodes, self.instances, blas_by_offset,
                tlas_capacity=self.tlas_capacity)
        return self._device

    def refit(self, new_transforms) -> device.DeviceScene:
        """Animated-transform path: rebuild the (small) TLAS over the
        existing BLASes and update only the TLAS block + instance arrays
        of the device scene in place -- the reference has no refit; it
        rebuilds and re-uploads the whole TLAS buffer.

        new_transforms: [I, 4, 4] row-major, in *creation order* (the
        order the instances were passed to BuildTopAccelStruct).
        Requires the TLAS to have been built via BuildTopAccelStruct
        (source_instances retained) and device_scene() materialized with
        a capacity (set automatically).
        """
        from radiance_tpu.bvh import builder

        assert self.source_instances is not None, "refit needs source instances"
        scene = self.device_scene()
        for inst, tf in zip(self.source_instances, new_transforms):
            inst.transform = np.ascontiguousarray(tf, np.float32)
        nodes, dev_inst, new_offsets, _ = builder.build_tlas_arrays(
            self.source_instances)
        # Serialized byte offsets shift when the TLAS tree shape changes
        # under new transforms, so map device BLAS roots by *object
        # identity*: the device node layout was fixed at device_scene()
        # time (BLAS blocks in ascending original-offset order after the
        # padded TLAS block) and never moves across refits.
        if self._device_blas_order is None:
            self._device_blas_order = [
                b for _, b in sorted(self.blas_offsets, key=lambda p: p[0])]
        root_by_blas = {}
        node_base = self.tlas_capacity
        for b in self._device_blas_order:
            root_by_blas[id(b)] = node_base
            node_base += self._blas_row_count(b)
        blas_root_by_offset = {off: root_by_blas[id(b)]
                               for off, b in new_offsets}
        self.nodes = nodes
        self.instances = dev_inst
        self._blob = None    # lazy: reserialized only if .blob is read
        self.blas_offsets = new_offsets
        self._device = device.update_tlas(
            scene, nodes, dev_inst, blas_root_by_offset, self.tlas_capacity)
        return self._device

    _row_counts: Optional[dict] = None

    def _blas_row_count(self, blas) -> int:
        """Post-split row count of a BLAS block (must mirror
        device.build_device_scene's leaf normalization)."""
        if self._row_counts is None:
            self._row_counts = {}
        key = id(blas)
        if key not in self._row_counts:
            t = device._decode_nodes(blas.nodes, device.KIND_TRI_LEAF)
            device._split_oversized_leaves(t, config.LEAF_WIDTH)
            self._row_counts[key] = len(t.kind)
        return self._row_counts[key]


def BuildTopAccelStruct(instances: Sequence[types.Instance],
                        verbose: bool = False) -> TopAccelStruct:
    """Build a TLAS over instances (reference: radiance.cpp:54-84)."""
    t0 = time.time()
    nodes, dev_inst, blas_offsets, max_depth = builder.build_tlas_arrays(list(instances))
    blob = serialize.serialize_tlas(nodes, dev_inst, blas_offsets)
    if verbose:
        print(f"TLAS build: {len(instances)} instances, {len(nodes)} nodes, "
              f"depth {max_depth}, {time.time() - t0:.3f}s")
    return TopAccelStruct(_blob=blob, nodes=nodes, instances=dev_inst,
                          blas_offsets=blas_offsets,
                          source_instances=list(instances),
                          tlas_capacity=device.tlas_capacity_for(len(instances)))


def BuildAccelStruct(arg, verbose: bool = False):
    """Overloaded like the reference: Mesh -> BLAS, [Instance] -> TLAS."""
    if isinstance(arg, types.Mesh):
        return BuildBottomAccelStruct(arg, verbose=verbose)
    return BuildTopAccelStruct(arg, verbose=verbose)


def TopAccelStructToFile(accel: TopAccelStruct, path: str) -> None:
    """Checkpoint (reference: radiance.cpp:428-448)."""
    serialize.tlas_to_file(accel.blob, path)


def FileToTopAccelStruct(path: str) -> TopAccelStruct:
    """Resume (reference: radiance.cpp:450-479).

    Loads must behave exactly like builds (the reference's cache path
    produces the same device buffer bytes): the TLAS block is padded to
    the same capacity BuildTopAccelStruct would use, so cache-loaded and
    fresh scenes are array-identical.
    """
    parsed = serialize.tlas_from_file(path)

    cap = device.tlas_capacity_for(len(parsed.instances))
    accel = TopAccelStruct(_blob=parsed.blob, nodes=parsed.nodes,
                           instances=parsed.instances, blas_offsets=[],
                           tlas_capacity=cap)
    accel._device = device.build_device_scene(
        parsed.nodes, parsed.instances, parsed.blas, tlas_capacity=cap)
    return accel
