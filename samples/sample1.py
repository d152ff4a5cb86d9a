"""Sample 1: progressive PBR path tracer through the full RD-style API.

Port of the reference's sample1 (reference: samples/sample1.cpp:363-448
rayTracer() + render()): builds every buffer through the Platform API,
binds the 14-descriptor pipeline, and runs the progressive render loop
with host-side totalSamples accumulation control (sample1.cpp:479-490).

Scene: procedural Cornell box (the reference's GLB benchmark assets are
not in its repo); swap in `--glb <path>` to load a glTF binary scene.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from radiance_tpu.api import accel, pipeline, platform
from radiance_tpu.core import types
from radiance_tpu.engine import programs
from radiance_tpu.scene import procedural
from radiance_tpu.utils import image as image_io


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--debug", type=int, default=0)
    ap.add_argument("--glb", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--interactive", action="store_true",
                    help="progressive viewer loop (renderLoop analog); "
                         "edit camera/light/debug live via stdin lines "
                         "like 'camera.x 1.5' or a --controls-file")
    ap.add_argument("--controls-file", type=str, default=None,
                    help="JSON file watched for parameter edits")
    ap.add_argument("--web", action="store_true",
                    help="serve the progressive viewer to a browser "
                         "(the windowed-inspector analog: live frame, "
                         "camera/light/debug controls, Save button)")
    ap.add_argument("--web-port", type=int, default=8642)
    args = ap.parse_args()

    plt = platform.Platform.GetPlatform()

    # --- scene content (Scene::Load equivalent) ---
    if args.glb:
        from radiance_tpu.scene import loader
        scene = loader.load_scene(args.glb, use_cache=True)
    else:
        scene = procedural.cornell_box(light_dir=(0.3, -1.0, -0.4),
                                       light_intensity=3.0, verbose=True)

    # --- camera + frame properties, written through the buffer API ---
    cam = types.PhysicalCamera(
        width_pixel=float(args.width), height_pixel=float(args.height),
        focal_length=0.035, sensor_width=0.05, focal_distance=8.0,
        f_stop=0.0, x=0.0, y=0.0, z=4.0, wx=0.0, wy=0.0, wz=0.0)
    rtprop = types.RayTraceProperties(
        total_samples=0, batch_size=args.batch, depth=args.depth,
        debug=args.debug)
    props = types.SceneProperties(lights=[types.DirLight(
        direction=(0.3, -1.0, -0.4, 0.0), color=(3.0, 3.0, 3.0, 1.0))])

    n = args.width * args.height
    rd_rtprop = platform.CreateBuffer(plt, 16)
    platform.WriteBuffer(plt, rd_rtprop, 16, rtprop.to_numpy())
    rd_image = platform.CreateImage(plt, args.width, args.height)
    rd_scratch = platform.CreateBuffer(plt, n * 4 * 4)
    rd_cam = platform.CreateBuffer(plt, types.PHYSICAL_CAMERA_DTYPE.itemsize)
    platform.WriteBuffer(plt, rd_cam, rd_cam.size, cam.to_numpy())
    rd_props = platform.CreateBuffer(plt, types.SCENE_PROPERTIES_DTYPE.itemsize)
    platform.WriteBuffer(plt, rd_props, rd_props.size, props.to_numpy())

    mesh_infos = np.concatenate([m.to_numpy().reshape(1) for m in scene.mesh_infos])
    rd_mesh_info = platform.CreateBuffer(plt, mesh_infos.nbytes)
    platform.WriteBuffer(plt, rd_mesh_info, mesh_infos.nbytes, mesh_infos)
    mats = np.concatenate([m.to_numpy().reshape(1) for m in scene.materials])
    rd_mats = platform.CreateBuffer(plt, mats.nbytes)
    platform.WriteBuffer(plt, rd_mats, mats.nbytes, mats)

    def flat_buffer(arr):
        arr = np.ascontiguousarray(arr)
        buf = platform.CreateBuffer(plt, arr.nbytes)
        platform.WriteBuffer(plt, buf, arr.nbytes, arr)
        return buf

    import jax.numpy as jnp
    res = scene.resources
    rd_vertex = flat_buffer(np.asarray(res["vertex_data"]))
    rd_index = flat_buffer(np.asarray(res["index_data"]).astype(np.uint32))
    rd_uv = flat_buffer(np.asarray(res["uv_data"]))
    rd_normal = flat_buffer(np.asarray(res["normal_data"]))
    rd_textures = platform.CreateImageArray(plt, 4, 4, 1)
    rd_sampler = platform.CreateSampler(plt, 2, 1)

    # --- pipeline (sample1.cpp:387-407) ---
    program = programs.sample1_program()
    shader = pipeline.CreateShaderModule(plt, program)
    pl = pipeline.CreatePipeline({
        "maxRayRecursionDepth": 1,
        "layout": pipeline.CreatePipelineLayout(
            [pipeline.BUFFER_TYPE] * 11 + [pipeline.TEX_ARRAY_TYPE,
                                           pipeline.IMAGE_SAMPLER_TYPE,
                                           pipeline.ACCEL_STRUCT_TYPE]),
        "modules": [shader],
    })
    desc = pipeline.CreateDescriptorSet([
        rd_rtprop, rd_scratch, rd_image, rd_cam, rd_props,
        rd_mesh_info, rd_vertex, rd_index, rd_uv, rd_normal, rd_mats,
        rd_textures, rd_sampler, scene.tlas])
    pipeline.BindPipeline(plt, pl)
    pipeline.BindDescriptorSet(plt, desc)

    # --- progressive render loop (sample1.cpp:441-490) ---
    def render_frame(_data):
        """The render() callback (sample1.cpp:455-490): trace, read the
        image, advance totalSamples on the host."""
        pipeline.TraceRays(plt, 0, 0, 0, args.width, args.height)
        img = platform.ReadBuffer(plt, rd_image, rd_image.size).reshape(
            args.height, args.width, 4)
        rt = np.frombuffer(platform.ReadBuffer(plt, rd_rtprop, 16),
                           dtype=types.RAY_TRACE_PROPERTIES_DTYPE).copy()
        rt["totalSamples"] += rt["batchSize"]
        platform.WriteBuffer(plt, rd_rtprop, 16, rt)
        return img

    if args.interactive or args.web:
        from radiance_tpu.tools import viewer

        def apply_controls(updates):
            """RenderSceneConfigUI analog (sample1.cpp:501-548): mutate
            camera/light/rtprop buffers from the edits and reset
            totalSamples so accumulation restarts (sample1.cpp:482)."""
            cam_arr = np.frombuffer(
                platform.ReadBuffer(plt, rd_cam, rd_cam.size),
                dtype=types.PHYSICAL_CAMERA_DTYPE).copy()
            props_arr = np.frombuffer(
                platform.ReadBuffer(plt, rd_props, rd_props.size),
                dtype=types.SCENE_PROPERTIES_DTYPE).copy()
            rt = np.frombuffer(platform.ReadBuffer(plt, rd_rtprop, 16),
                               dtype=types.RAY_TRACE_PROPERTIES_DTYPE).copy()
            cam_dirty = props_dirty = False
            for key, val in updates.items():
                scope, _, field = key.partition(".")
                if scope == "camera" and field in cam_arr.dtype.names:
                    cam_arr[field] = float(val)
                    cam_dirty = True
                elif scope == "light" and field == "dir":
                    props_arr["lights"]["direction"][0, 0, :3] = val
                    props_dirty = True
                elif scope == "light" and field == "color":
                    props_arr["lights"]["color"][0, 0, :3] = val
                    props_dirty = True
                elif scope in ("debug", "batch", "depth"):
                    name = {"debug": "debug", "batch": "batchSize",
                            "depth": "depth"}[scope]
                    rt[name] = int(val)
                else:
                    print(f"(ignored control {key!r})")
                    continue
                print(f"set {key} = {val}")
            if cam_dirty:
                platform.WriteBuffer(plt, rd_cam, rd_cam.size, cam_arr)
            if props_dirty:
                platform.WriteBuffer(plt, rd_props, rd_props.size, props_arr)
            rt["totalSamples"] = 0  # restart accumulation on any edit
            platform.WriteBuffer(plt, rd_rtprop, 16, rt)

        out = args.out or "sample1_progressive.png"
        if args.web:
            from radiance_tpu.tools import web_viewer
            web_viewer.render_loop_web(
                render_frame, None, frames=args.frames or 0,
                out_path=out, port=args.web_port,
                controls={"camera.x": 0.0, "camera.y": 0.0,
                          "camera.z": 4.0, "camera.wx": 0.0,
                          "camera.wy": 0.0, "camera.wz": 0.0,
                          "debug": args.debug, "batch": args.batch,
                          "depth": args.depth},
                on_change=apply_controls)
        else:
            viewer.render_loop(
                render_frame, None, frames=args.frames or 0,
                out_path=out,
                controls=viewer.ControlChannel(
                    use_stdin=True, watch_file=args.controls_file),
                on_change=apply_controls)
        return

    for frame in range(args.frames):
        t0 = time.time()
        img = render_frame(None)
        dt = time.time() - t0
        rt = np.frombuffer(platform.ReadBuffer(plt, rd_rtprop, 16),
                           dtype=types.RAY_TRACE_PROPERTIES_DTYPE)
        rays = args.width * args.height * args.batch * args.depth
        print(f"frame {frame}: {dt:.3f}s  (~{rays / dt / 1e6:.2f} Mrays/s upper bound), "
              f"totalSamples={int(rt['totalSamples'][0])}")

    out = args.out or image_io.timestamped_path("sample1", "png")
    image_io.write_image(out, img)
    print(f"Writing image with extent: <{args.width}, {args.height}> -> {out}")


if __name__ == "__main__":
    main()
