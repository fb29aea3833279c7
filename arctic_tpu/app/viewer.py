"""Interactive browser viewer — the SDL window + ImGui analogue for a
headless GPU host (SURVEY.md §7 phase-2 "optional interactive viewer").

Zero dependencies: a localhost http.server streams PNG frames; an HTML page
captures WASD/space/ctrl + mouse-drag (right button) and posts them back,
mirroring App::handle_event (app.cpp:109-148). Full ImGui-window parity
(app.cpp:402-523):

- Stats window: frame time / FPS text plus a dual-axis frame-time+FPS
  graph over the last 1000 frames (app.cpp:404-453, ImPlot analogue).
- Settings window: camera speed / sensitivity / position / rotation /
  near-far, ambient, sun position / rotation / HDR color, gamma, tonemap,
  exposure (app.cpp:454-493).
- Lights window: per-light position drag + HDR color, "Add" up to 16
  (app.cpp:495-523) — edits upload next frame like m_update_lights.
- Objects window (scene editor — the reference's unticked README.md:17
  roadmap item): per-object translate / yaw-pitch rotate / uniform scale
  about the object's own origin, composed onto the load-time TRS
  (core.scene.with_object_trs); a geometry edit invalidates the sun cache
  so the shadow chain rebuilds.

    python -m arctic_tpu.app.viewer --procedural cornell --width 640 --height 360
    # then open http://localhost:8000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from arctic_tpu.utils.profiling import FrameStats

_PAGE = """<!doctype html><html><head><title>arctic_tpu</title><style>
body{background:#111;color:#ccc;font-family:monospace;margin:12px}
canvas{border:1px solid #444}input{width:56px;background:#222;color:#ccc;border:1px solid #555}
select{background:#222;color:#ccc}fieldset{border:1px solid #444;margin-top:8px;display:inline-block;vertical-align:top}
button{background:#333;color:#ccc;border:1px solid #666}</style></head><body>
<div>arctic_tpu viewer — WASD/space/ctrl move, right-drag look</div>
<canvas id=c width=%W% height=%H% tabindex=0></canvas>
<fieldset><legend>stats</legend><div id=stats>-</div>
<canvas id=plot width=420 height=90></canvas>
<div style="font-size:11px">yellow: frame ms (left) / cyan: fps (right), last 1000 frames</div></fieldset>
<fieldset><legend>settings</legend>
resolution <input id=rw value=%W%> x <input id=rh value=%H%>
<button id=applyres>apply</button> (recompiles — the PSO-rebuild analogue)<br>
cam speed <input id=speed value=10> sens <input id=sens value=0.5><br>
cam pos <input id=cpx> <input id=cpy> <input id=cpz>
rot <input id=crx> <input id=cry><br>
near <input id=znear value=0.1> far <input id=zfar value=1000><br>
ambient <input id=ambient value=0.1><br>
sun pos <input id=spx value=-10> <input id=spy value=32> <input id=spz value=-2.48><br>
sun rot <input id=srx value=-70> <input id=sry value=12><br>
sun color <input id=scr value=8> <input id=scg value=8> <input id=scb value=8><br>
gamma <input id=gamma value=2.2>
tonemap <select id=tm><option value=0>reinhard</option><option value=1>exposure</option><option value=2>aces</option></select>
exposure <input id=exposure value=1.0></fieldset>
<fieldset><legend>lights (max 16)</legend><div id=lights></div>
<button id=addlight>Add</button></fieldset>
<fieldset><legend>objects (scene editor)</legend>
object <select id=objid></select><br>
move <input id=odx value=0> <input id=ody value=0> <input id=odz value=0><br>
rot <input id=oyaw value=0> <input id=opitch value=0> scale <input id=oscale value=1><br>
<button id=objapply>apply</button> <button id=objreset>reset</button></fieldset>
<script>
const c=document.getElementById('c'),ctx=c.getContext('2d');
const plot=document.getElementById('plot'),pctx=plot.getContext('2d');
let keys={},dx=0,dy=0,drag=false,t0=performance.now();
let hist_ms=[],hist_fps=[];
let camDirty=false;
c.onmousedown=e=>{if(e.button==2)drag=true};
c.onmouseup=e=>{if(e.button==2)drag=false};
c.oncontextmenu=e=>e.preventDefault();
c.onmousemove=e=>{if(drag){dx+=e.movementX;dy+=e.movementY}};
window.onkeydown=e=>{if(document.activeElement.tagName!=='INPUT')keys[e.code]=1};
window.onkeyup=e=>keys[e.code]=0;
const v=id=>document.getElementById(id).value;
let pendingRes=null;
document.getElementById('applyres').onclick=()=>{pendingRes=v('rw')+'x'+v('rh')};
const camIds=['cpx','cpy','cpz','crx','cry'];
camIds.forEach(id=>{document.getElementById(id).onchange=()=>camDirty=true});

const lightsDiv=document.getElementById('lights');
function addLightRow(p,col){
  if(lightsDiv.children.length>=16)return;
  const d=document.createElement('div');
  d.innerHTML='pos <input class=lx value='+p[0]+'> <input class=ly value='+p[1]+'> <input class=lz value='+p[2]+
    '> color <input class=lr value='+col[0]+'> <input class=lg value='+col[1]+'> <input class=lb value='+col[2]+
    '> <button class=del>x</button>';
  d.querySelector('.del').onclick=()=>d.remove();
  lightsDiv.appendChild(d);
}
document.getElementById('addlight').onclick=()=>addLightRow([0,1,0],[10,0,0]);
addLightRow([0,1,0],[10,0,0]);  // default red light (app.hpp:59-62)
const objSel=document.getElementById('objid');
for(let i=0;i<%NOBJ%;i++){const o=document.createElement('option');o.value=i;o.textContent='object '+i;objSel.appendChild(o)}
let objEdit=null;
function objEditJson(){return JSON.stringify({id:parseInt(objSel.value)||0,
  dt:['odx','ody','odz'].map(k=>parseFloat(v(k))||0),
  rot:['oyaw','opitch'].map(k=>parseFloat(v(k))||0),
  scale:parseFloat(v('oscale'))||1})}
document.getElementById('objapply').onclick=()=>{objEdit=objEditJson()};
document.getElementById('objreset').onclick=()=>{
  ['odx','ody','odz','oyaw','opitch'].forEach(k=>document.getElementById(k).value=0);
  document.getElementById('oscale').value=1;objEdit=objEditJson()};
function lightsJson(){
  return JSON.stringify([...lightsDiv.children].map(d=>({
    pos:['lx','ly','lz'].map(k=>parseFloat(d.querySelector('.'+k).value)||0),
    color:['lr','lg','lb'].map(k=>parseFloat(d.querySelector('.'+k).value)||0)})));
}
function drawPlot(){
  pctx.fillStyle='#181818';pctx.fillRect(0,0,420,90);
  if(!hist_ms.length)return;
  const maxMs=Math.max(...hist_ms)*1.1,maxFps=Math.max(...hist_fps)*1.1;
  pctx.strokeStyle='#cc3';pctx.beginPath();
  hist_ms.forEach((m,i)=>{const x=i*420/1000,y=90-m/maxMs*88;i?pctx.lineTo(x,y):pctx.moveTo(x,y)});
  pctx.stroke();
  pctx.strokeStyle='#3cc';pctx.beginPath();
  hist_fps.forEach((f,i)=>{const x=i*420/1000,y=90-f/maxFps*88;i?pctx.lineTo(x,y):pctx.moveTo(x,y)});
  pctx.stroke();
}
async function loop(){
  const q=new URLSearchParams({
    f:(keys.KeyW?1:0)-(keys.KeyS?1:0), r:(keys.KeyD?1:0)-(keys.KeyA?1:0),
    u:(keys.Space?1:0)-(keys.ControlLeft?1:0), dx:dx, dy:dy,
    speed:v('speed'), sens:v('sens'), znear:v('znear'), zfar:v('zfar'),
    ambient:v('ambient'), gamma:v('gamma'), exposure:v('exposure'), tm:v('tm'),
    sun_pos:[v('spx'),v('spy'),v('spz')].join(','),
    sun_rot:[v('srx'),v('sry')].join(','),
    sun_color:[v('scr'),v('scg'),v('scb')].join(','),
    lights:lightsJson()});
  if(camDirty){
    q.set('cam_pos',[v('cpx'),v('cpy'),v('cpz')].join(','));
    q.set('cam_rot',[v('crx'),v('cry')].join(','));
    camDirty=false;
  }
  if(pendingRes){q.set('res',pendingRes);pendingRes=null}
  if(objEdit){q.set('obj_edit',objEdit);objEdit=null}
  dx=0;dy=0;
  const r=await fetch('/frame?'+q); const b=await r.blob();
  const img=await createImageBitmap(b);
  if(img.width!=c.width||img.height!=c.height){c.width=img.width;c.height=img.height}
  ctx.drawImage(img,0,0);
  const st=JSON.parse(r.headers.get('X-Stats')||'{}');
  const t1=performance.now(),ms=t1-t0;t0=t1;
  hist_ms.push(st.ms||ms);hist_fps.push(1000/(st.ms||ms));
  if(hist_ms.length>1000){hist_ms.shift();hist_fps.shift()}
  document.getElementById('stats').textContent=
    (st.ms||ms).toFixed(1)+' ms  '+(1000/(st.ms||ms)).toFixed(1)+' fps'
    +(st.fps_avg?'  avg '+st.fps_avg.toFixed(1)+' fps':'')
    +(st.overflow?'  OVERFLOW: '+st.overflow:'');
  drawPlot();
  if(st.cam&&document.activeElement.tagName!=='INPUT'){
    ['cpx','cpy','cpz'].forEach((id,i)=>document.getElementById(id).value=st.cam.pos[i].toFixed(2));
    ['crx','cry'].forEach((id,i)=>document.getElementById(id).value=st.cam.rot[i].toFixed(1));
  }
  requestAnimationFrame(loop);
}
loop();
</script></body></html>"""


def _object_edit_matrix(orig, dt, rot, scale):
    """World TRS for an Objects-window edit: translate by ``dt`` and rotate
    (yaw, pitch degrees) / scale uniformly about the object's own origin
    (the load-time matrix's translation column), composed onto the load-time
    TRS. Identity inputs return the original matrix exactly."""
    orig = np.asarray(orig, np.float64)
    yaw, pitch = np.radians(rot[0]), np.radians(rot[1])
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    r = (ry @ rx) * float(scale)
    p = orig[:3, 3]
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = p + np.asarray(dt, np.float64) - r @ p
    return (m @ orig).astype(np.float32)


class ViewerState:
    def __init__(self, buffers, params, settings, config, render):
        self.buffers = buffers
        self.params = params
        self.settings = settings
        self.config = config
        self.render = render
        self.lock = threading.Lock()
        self.last_time = time.perf_counter()
        self.stats = FrameStats()

        # Sun-dirty shadow caching: while sun AND geometry are unchanged,
        # frames reuse the cached shadow map
        # (pipeline.build_sun_cache) and skip the whole shadow chain;
        # editing the sun (Settings) or an object (Objects editor) rebuilds
        # it. The production equivalent of cached stationary-light shadows.
        self.sun_cache = None
        self.sun_key = None
        self._cache_builder = None
        self._cached_render = None
        self._cache_stats = {}

        # Objects editor: edits compose onto the load-time TRS (kept here),
        # so repeated edits of one object never accumulate rounding.
        self.orig_object_trs = np.asarray(buffers.geometry.object_trs).copy()
        self._last_obj_edit = None

        from arctic_tpu.app.camera import FlyCamera

        self.fly = FlyCamera()

    def step(self, q: dict) -> tuple[bytes, dict]:
        """One viewer frame: apply inputs/settings edits, render, encode.

        Returns (png bytes, stats dict). Mirrors App::update + build_ui
        (app.cpp:150-171, 402-523): every Settings/Lights field arrives as a
        query param and is applied before the frame renders.
        """
        import jax.numpy as jnp

        from arctic_tpu.core.scene import PointLights
        from arctic_tpu.io.images import encode_png

        def f(name, default=0.0):
            try:
                return float(q.get(name, [default])[0])
            except ValueError:
                return default

        def vec(name, n, default=None):
            if name not in q:
                return default
            try:
                vals = [float(x) for x in q[name][0].split(",")]
                return vals if len(vals) == n else default
            except ValueError:
                return default

        with self.lock:
            now = time.perf_counter()
            dt = min(now - self.last_time, 0.1)
            self.last_time = now

            # Runtime resolution change = new RenderConfig + recompile,
            # the PSO-rebuild analogue of Renderer::resize
            # (app.cpp:526-535; the reference resizes only the swapchain
            # and leaves its intermediate targets stale — we rebuild all
            # targets consistently, trading a compile pause).
            if "res" in q:
                try:
                    w, h = (int(x) for x in q["res"][0].split("x"))
                except ValueError:
                    w = h = 0
                if (
                    64 <= w <= 4096 and 64 <= h <= 4096
                    and (w, h) != (self.config.width, self.config.height)
                ):
                    from arctic_tpu.models import pipeline

                    config = self.config.with_resolution(w, h)
                    if not config.force_bruteforce:
                        config = pipeline.autotune_pair_caps(
                            self.buffers, self.params, config, margin=4.0
                        )
                    self.config = config
                    self.render = pipeline.make_renderer_stats(config)
                    self.sun_cache = self.sun_key = None
                    self._cache_builder = self._cached_render = None
                    self.params = dataclasses.replace(
                        self.params,
                        camera=dataclasses.replace(
                            self.params.camera,
                            aspect=jnp.float32(w / h),
                        ),
                    )
                    print(f"viewer: resolution -> {w}x{h} (recompiling)")

            self.fly.speed = f("speed", self.fly.speed)
            self.fly.sensitivity = f("sens", self.fly.sensitivity)
            cam = self.params.camera
            cp = vec("cam_pos", 3)
            cr = vec("cam_rot", 2)
            if cp is not None:
                cam = dataclasses.replace(cam, eye=jnp.asarray(cp, jnp.float32))
            if cr is not None:
                cam = dataclasses.replace(cam, rotation=jnp.asarray(cr, jnp.float32))
            cam = dataclasses.replace(
                cam,
                z_near=jnp.float32(f("znear", float(cam.z_near))),
                z_far=jnp.float32(f("zfar", float(cam.z_far))),
            )
            cam = self.fly.move(cam, dt, f("f"), f("r"), f("u"))
            cam = self.fly.look(cam, f("dx"), f("dy"))

            sun = self.params.sun
            sp = vec("sun_pos", 3)
            sr = vec("sun_rot", 2)
            sc = vec("sun_color", 3)
            if sp is not None:
                sun = dataclasses.replace(sun, position=jnp.asarray(sp, jnp.float32))
            if sr is not None:
                sun = dataclasses.replace(sun, rotation=jnp.asarray(sr, jnp.float32))
            if sc is not None:
                sun = dataclasses.replace(sun, color=jnp.asarray(sc, jnp.float32))

            lights = self.params.point_lights
            if "lights" in q:
                try:
                    spec = json.loads(q["lights"][0])
                    lights = PointLights.from_list(
                        [(tuple(l["pos"]), tuple(l["color"])) for l in spec]
                    )
                except (ValueError, KeyError, TypeError):
                    pass

            if "obj_edit" in q:
                # Objects editor (scene-editor parity item): replace the
                # object's world TRS and invalidate the sun cache — moved
                # geometry casts a different shadow.
                edit = None
                try:
                    spec = json.loads(q["obj_edit"][0])
                    edit = (
                        int(spec["id"]),
                        tuple(float(x) for x in spec.get("dt", (0, 0, 0))),
                        tuple(float(x) for x in spec.get("rot", (0, 0))),
                        float(spec.get("scale", 1.0)),
                    )
                except (ValueError, KeyError, TypeError):
                    pass
                if (
                    edit is not None
                    and 0 <= edit[0] < len(self.orig_object_trs)
                    and edit != self._last_obj_edit
                ):
                    from arctic_tpu.core.scene import with_object_trs

                    trs = _object_edit_matrix(
                        self.orig_object_trs[edit[0]], edit[1], edit[2], edit[3]
                    )
                    self.buffers = dataclasses.replace(
                        self.buffers,
                        geometry=with_object_trs(
                            self.buffers.geometry, edit[0], trs
                        ),
                    )
                    self._last_obj_edit = edit
                    self.sun_key = None  # geometry edit: shadow chain rebuilds

            self.params = dataclasses.replace(
                self.params,
                camera=cam,
                sun=sun,
                point_lights=lights,
                ambient=jnp.float32(f("ambient", 0.1)),
            )
            self.settings = dataclasses.replace(
                self.settings,
                gamma=jnp.float32(f("gamma", 2.2)),
                exposure=jnp.float32(f("exposure", 1.0)),
                tm_method=jnp.int32(int(f("tm", 0))),
            )
            t_render0 = time.perf_counter()
            if not self.config.force_bruteforce:
                key = (
                    tuple(np.asarray(sun.position).tolist()),
                    tuple(np.asarray(sun.rotation).tolist()),
                )
                if self._cache_builder is None:
                    import functools

                    import jax

                    from arctic_tpu.models import pipeline

                    self._cache_builder = jax.jit(
                        functools.partial(pipeline.build_sun_cache, config=self.config)
                    )
                    self._cached_render = pipeline.make_cached_renderer_stats(
                        self.config
                    )
                if key != self.sun_key:
                    self.sun_cache, self._cache_stats = self._cache_builder(
                        self.buffers, self.params
                    )
                    self.sun_key = key
                img, rstats = self._cached_render(
                    self.buffers, self.params, self.settings, self.sun_cache
                )
                rstats = {**rstats, **self._cache_stats}  # real shadow stats
            else:
                img, rstats = self.render(self.buffers, self.params, self.settings)
            img = np.asarray(img)
            # Render + device->host download only (PNG encode and the
            # browser round-trip are not frame time; tick pairs would also
            # record the idle gap BETWEEN requests as frames).
            self.stats.add(time.perf_counter() - t_render0)
            # Camera/sun/lights are runtime-mutable, so a viewpoint can
            # exceed the autotuned pair caps; that silently drops fragments.
            # Keep it LOUD: surface the overflow in the HUD.
            overflow = []
            for pass_name in ("cam", "shadow"):
                pairs = int(rstats[f"{pass_name}_pairs"])
                cap = int(rstats[f"{pass_name}_pair_cap"])
                if pairs > cap:
                    overflow.append(f"{pass_name} {pairs}/{cap}")
            if overflow:
                print(f"viewer: PAIR BUFFER OVERFLOW ({', '.join(overflow)}) — "
                      "frame incomplete; restart with a larger margin")
            ms = self.stats.history[-1] * 1e3 if self.stats.history else 0.0
            recent = list(self.stats.history)[-60:]
            avg = sum(recent) / len(recent) if recent else 0.0
            stats = {
                "ms": round(ms, 2),
                "fps": round(1000.0 / ms, 2) if ms else 0.0,
                # Rolling live fps over the last 60 rendered frames — the
                # ImGui Stats-window number's analogue (app.cpp:404-453),
                # measuring render + download.
                "fps_avg": round(1.0 / avg, 2) if avg else 0.0,
                "overflow": ", ".join(overflow),
                "cam": {
                    "pos": [float(x) for x in np.asarray(self.params.camera.eye)],
                    "rot": [float(x) for x in np.asarray(self.params.camera.rotation)],
                },
            }
        return encode_png(np.asarray(img)), stats


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = (
                    _PAGE.replace("%W%", str(state.config.width))
                    .replace("%H%", str(state.config.height))
                    .replace("%NOBJ%", str(len(state.orig_object_trs)))
                    .encode()
                )
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/frame":
                png, stats = state.step(parse_qs(url.query))
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Stats", json.dumps(stats))
                self.end_headers()
                self.wfile.write(png)
            elif url.path == "/state":
                from arctic_tpu.utils.serialize import params_to_dict

                body = json.dumps(
                    params_to_dict(state.params, state.settings)
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/stats":
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.end_headers()
                self.wfile.write(state.stats.summary().encode())
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def serve(state: ViewerState, port: int = 8000):
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    print(f"viewer: http://localhost:{port}")
    server.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("scene", nargs="?")
    p.add_argument("--procedural", choices=["cornell", "sponza"], default="cornell")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--shadow-size", type=int, default=1024)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--bruteforce", action="store_true")
    args = p.parse_args(argv)

    from arctic_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from arctic_tpu.core.config import RenderConfig
    from arctic_tpu.core.scene import default_scene_params, default_settings
    from arctic_tpu.io.build import build_buffers
    from arctic_tpu.models import pipeline

    if args.scene:
        from arctic_tpu.io.load import load_scene_file

        meshes, objects, materials, env = load_scene_file(args.scene)
    else:
        from arctic_tpu.io import procedural

        fn = (
            procedural.cornell_like_scene
            if args.procedural == "cornell"
            else procedural.sponza_like_scene
        )
        meshes, objects, materials, env = fn()
    config = RenderConfig(
        width=args.width,
        height=args.height,
        shadow_size=args.shadow_size,
        force_bruteforce=args.bruteforce,
    )
    buffers = build_buffers(meshes, objects, materials, env)
    params = default_scene_params(aspect=args.width / args.height)
    if not config.force_bruteforce:
        # Interactive camera roams, so use a generous margin over the
        # initial viewpoint's measured pair counts.
        config = pipeline.autotune_pair_caps(buffers, params, config, margin=4.0)
    state = ViewerState(
        buffers,
        params,
        default_settings(),
        config,
        pipeline.make_renderer_stats(config),
    )
    serve(state, args.port)


if __name__ == "__main__":
    main()
