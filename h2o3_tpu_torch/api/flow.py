"""Flow — the in-node notebook UI (h2o-web's role, compressed).

A copy of h2o3_tpu/api/flow.py (the port keeps its own; the page is
served unchanged at ``/flow/index.html``).

Reference: h2o-web/ serves the CoffeeScript Flow notebook from the node
itself at /flow/index.html; cells run "routines" that call the REST API
(importFiles, parse, buildModel, predict, getFrames, ...) and render
results as tables.

Here: one dependency-free HTML/JS page with the same shape — notebook of
cells, each cell an editable REST call (method, path, params) created
from assist buttons or by hand, executed against this server's /3 and
/99 endpoints, results rendered as tables where the payload is tabular
(frames preview, leaderboard, jobs) and as JSON otherwise. Notebooks
save/load as .flow JSON (localStorage + file download), mirroring
Flow's notebook files.
"""

FLOW_HTML = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>Flow — h2o3-tpu</title>
<style>
 body { font-family: -apple-system, 'Segoe UI', sans-serif; margin: 0;
        background: #f4f5f7; }
 #top { background: #1b2330; color: #ffd24d; padding: 10px 16px;
        display: flex; align-items: center; gap: 16px; }
 #top h1 { font-size: 16px; margin: 0; }
 #top .sub { color: #9aa7bd; font-size: 12px; }
 #assist { padding: 8px 16px; display: flex; flex-wrap: wrap; gap: 6px; }
 #assist button, .cellbar button {
   background: #fff; border: 1px solid #c8cdd6; border-radius: 4px;
   padding: 4px 10px; cursor: pointer; font-size: 12px; }
 #assist button:hover, .cellbar button:hover { background: #eef3ff; }
 #cells { padding: 0 16px 40px; }
 .cell { background: #fff; border: 1px solid #d9dde3; border-radius: 6px;
         margin: 10px 0; }
 .cell.running { border-color: #ffd24d; }
 .cellbar { display: flex; gap: 6px; padding: 6px 8px;
            border-bottom: 1px solid #eee; align-items: center; }
 .cellbar .label { font-size: 11px; color: #667; margin-right: auto; }
 .cell textarea { width: calc(100% - 20px); margin: 8px 10px;
                  font-family: ui-monospace, monospace; font-size: 12px;
                  border: 1px solid #e3e6ea; border-radius: 4px;
                  padding: 6px; min-height: 54px; box-sizing: border-box; }
 .out { margin: 0 10px 10px; font-size: 12px; overflow-x: auto; }
 .out pre { background: #0e1420; color: #c9e3ff; padding: 8px;
            border-radius: 4px; max-height: 320px; overflow: auto; }
 .out table { border-collapse: collapse; }
 .out th, .out td { border: 1px solid #d5dae2; padding: 3px 8px;
                    font-size: 12px; }
 .out th { background: #eef1f5; }
 .err { color: #b00020; }
</style>
</head>
<body>
<div id="top">
 <h1>Flow</h1>
 <span class="sub" id="cloudinfo">connecting…</span>
 <span style="margin-left:auto"></span>
 <button onclick="saveFlow()">Save .flow</button>
 <button onclick="document.getElementById('loadfile').click()">Load</button>
 <input type="file" id="loadfile" style="display:none"
        onchange="loadFlowFile(this.files[0])">
</div>
<div id="assist">
 <button onclick="addCell('POST /3/ImportFiles\n{\"path\": \"/path/to/data.csv\"}')">importFiles</button>
 <button onclick="addCell('POST /3/Parse\n{\"source_frames\": \"/path/to/data.csv\"}')">parse</button>
 <button onclick="addCell('GET /3/Frames\n{}')">getFrames</button>
 <button onclick="addCell('GET /3/Models\n{}')">getModels</button>
 <button onclick="addCell('POST /3/ModelBuilders/gbm\n{\"training_frame\": \"FRAME_KEY\", \"response_column\": \"y\", \"ntrees\": 20}')">buildModel</button>
 <button onclick="addCell('POST /3/Predictions/models/MODEL/frames/FRAME\n{}')">predict</button>
 <button onclick="addCell('POST /99/Rapids\n{\"ast\": \"(+ 1 2)\"}')">rapids</button>
 <button onclick="addCell('POST /99/AutoMLBuilder\n{\"input_spec\": {\"training_frame\": \"FRAME_KEY\", \"response_column\": \"y\"}, \"build_control\": {\"stopping_criteria\": {\"max_models\": 4}}}')">runAutoML</button>
 <button onclick="addCell('GET /3/Jobs\n{}')">getJobs</button>
 <button onclick="addCell('GET /3/Cloud\n{}')">getCloud</button>
</div>
<div id="cells"></div>
<script>
let CELLS = [];

function el(tag, attrs, html) {
  const e = document.createElement(tag);
  for (const k in (attrs || {})) e.setAttribute(k, attrs[k]);
  if (html !== undefined) e.innerHTML = html;
  return e;
}

function addCell(text, outHtml) {
  const cell = el('div', {class: 'cell'});
  const bar = el('div', {class: 'cellbar'});
  const label = el('span', {class: 'label'}, 'cell ' + (CELLS.length + 1));
  const run = el('button', {}, '&#9654; Run');
  const del = el('button', {}, '&#10005;');
  const ta = el('textarea');
  ta.value = text || 'GET /3/Cloud\n{}';
  ta.addEventListener('keydown', ev => {
    if ((ev.ctrlKey || ev.metaKey) && ev.key === 'Enter') runCell(cell, ta, out);
  });
  const out = el('div', {class: 'out'});
  if (outHtml) out.innerHTML = outHtml;
  run.onclick = () => runCell(cell, ta, out);
  del.onclick = () => { cell.remove(); CELLS = CELLS.filter(c => c !== cell); };
  bar.append(label, run, del);
  cell.append(bar, ta, out);
  document.getElementById('cells').append(cell);
  CELLS.push(cell);
  ta.focus();
  return cell;
}

function parseCell(text) {
  const nl = text.indexOf('\n');
  const head = (nl < 0 ? text : text.slice(0, nl)).trim().split(/\s+/);
  const body = nl < 0 ? '{}' : text.slice(nl + 1).trim() || '{}';
  return {method: head[0].toUpperCase(), path: head[1],
          params: JSON.parse(body)};
}

async function call(method, path, params) {
  let url = path, opts = {method};
  const enc = o => Object.entries(o).map(([k, v]) =>
    encodeURIComponent(k) + '=' + encodeURIComponent(
      typeof v === 'object' ? JSON.stringify(v) : v)).join('&');
  if (method === 'GET') {
    if (Object.keys(params).length) url += '?' + enc(params);
  } else {
    opts.headers = {'Content-Type': 'application/x-www-form-urlencoded'};
    opts.body = enc(params);
  }
  const r = await fetch(url, opts);
  return r.json();
}

function esc(v) {
  return String(v).replace(/&/g, '&amp;').replace(/</g, '&lt;')
    .replace(/>/g, '&gt;').replace(/"/g, '&quot;');
}

function tableHTML(cols, rows) {
  let h = '<table><tr>' + cols.map(c => '<th>' + esc(c) + '</th>').join('') + '</tr>';
  for (const row of rows)
    h += '<tr>' + row.map(v => '<td>' + (v === null ? '' : esc(v)) + '</td>').join('') + '</tr>';
  return h + '</table>';
}

function render(out, data) {
  // tabular shapes: frame preview, leaderboard, jobs
  try {
    if (data.frames && data.frames[0] && data.frames[0].columns) {
      const f = data.frames[0];
      const cols = f.columns.map(c => c.label);
      const n = Math.min(10, (f.columns[0].data || []).length);
      const rows = [];
      for (let i = 0; i < n; i++) rows.push(f.columns.map(c => c.data[i]));
      out.innerHTML = '<p>' + esc(f.frame_id.name) + ': ' + f.rows +
        ' rows × ' + f.num_columns + ' cols</p>' + tableHTML(cols, rows);
      return;
    }
    if (data.leaderboard_table) {
      const t = data.leaderboard_table;
      out.innerHTML = tableHTML(t.columns || Object.keys(t[0] || {}),
        (t.data || t).map(r => Array.isArray(r) ? r : Object.values(r)));
      return;
    }
    if (data.jobs) {
      out.innerHTML = tableHTML(['key', 'description', 'status', 'progress'],
        data.jobs.map(j => [j.key ? (j.key.name || j.key) : '', j.description,
                            j.status, j.progress]));
      return;
    }
  } catch (e) { /* fall through to JSON */ }
  out.innerHTML = '<pre>' + esc(JSON.stringify(data, null, 1)) + '</pre>';
}

async function runCell(cell, ta, out) {
  cell.classList.add('running');
  out.innerHTML = '<pre>…</pre>';
  try {
    const {method, path, params} = parseCell(ta.value);
    let data = await call(method, path, params);
    // auto-poll async jobs (the Flow progress bar role)
    let jobKey = data.job && data.job.key && (data.job.key.name || data.job.key);
    while (jobKey) {
      const j = (await call('GET', '/3/Jobs/' + jobKey, {})).jobs[0];
      out.innerHTML = '<pre>job ' + esc(jobKey) + ': ' + esc(j.status) +
        ' ' + Math.round((j.progress || 0) * 100) + '%</pre>';
      if (j.status === 'DONE') { data = j; break; }
      if (j.status === 'FAILED' || j.status === 'CANCELLED') {
        data = j; break; }
      await new Promise(r => setTimeout(r, 500));
    }
    render(out, data);
  } catch (e) {
    out.innerHTML = '<pre class="err">' + e + '</pre>';
  }
  cell.classList.remove('running');
}

function saveFlow() {
  const doc = {version: 1, cells: CELLS.map(c =>
    ({input: c.querySelector('textarea').value}))};
  const blob = new Blob([JSON.stringify(doc, null, 1)],
                       {type: 'application/json'});
  const a = el('a', {download: 'notebook.flow',
                     href: URL.createObjectURL(blob)});
  a.click();
  localStorage.setItem('h2o3tpu_flow', JSON.stringify(doc));
}

function loadFlowFile(f) {
  if (!f) return;
  f.text().then(t => {
    document.getElementById('cells').innerHTML = '';
    CELLS = [];
    for (const c of JSON.parse(t).cells) addCell(c.input);
  });
}

(async () => {
  try {
    const c = await call('GET', '/3/Cloud', {});
    document.getElementById('cloudinfo').textContent =
      c.cloud_name + ' — ' + c.cloud_size + ' node(s), healthy: ' +
      c.cloud_healthy;
  } catch (e) {
    document.getElementById('cloudinfo').textContent = 'cloud unreachable';
  }
  const saved = localStorage.getItem('h2o3tpu_flow');
  if (saved) {
    for (const c of JSON.parse(saved).cells) addCell(c.input);
  } else {
    addCell('GET /3/Cloud\n{}');
  }
})();
</script>
</body>
</html>
"""
