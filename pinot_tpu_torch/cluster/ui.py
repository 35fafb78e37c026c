"""Controller web UI: a self-contained single-page app served at `/`.

Reference parity: the controller React SPA
(pinot-controller/src/main/resources/app/ — cluster home, table listing with
drill-down, instance listing, query console). Re-implemented as one embedded
HTML document driven by the controller's own REST endpoints (/tables,
/tables/{t}, /tables/{t}/segments, /tables/{t}/idealstate, /instances,
/brokers, /metrics) plus the broker's /query/sql for the console — no build
step, no framework, no egress.

This is the JAX package's `cluster/ui.py`: the same document, byte for byte.
"""

UI_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>pinot-tpu controller</title>
<style>
  body { font-family: -apple-system, "Segoe UI", Roboto, sans-serif; margin: 0; background:#f6f7f9; color:#1c2733; }
  header { background:#15304b; color:#fff; padding:10px 18px; display:flex; align-items:baseline; gap:18px; }
  header h1 { font-size:18px; margin:0; }
  nav a { color:#bcd3ea; margin-right:14px; cursor:pointer; text-decoration:none; }
  nav a.active { color:#fff; border-bottom:2px solid #6cb5f9; }
  main { padding:18px; max-width:1100px; }
  table { border-collapse:collapse; background:#fff; width:100%; box-shadow:0 1px 2px rgba(0,0,0,.08); }
  th, td { text-align:left; padding:7px 10px; border-bottom:1px solid #e4e8ee; font-size:13px; }
  th { background:#eef2f7; font-weight:600; }
  tr.clickable { cursor:pointer; }
  tr.clickable:hover { background:#f0f6ff; }
  pre { background:#fff; padding:10px; overflow:auto; font-size:12px; box-shadow:0 1px 2px rgba(0,0,0,.08); }
  textarea { width:100%; height:90px; font-family:monospace; font-size:13px; box-sizing:border-box; }
  button { background:#15604b; color:#fff; border:0; padding:7px 16px; border-radius:3px; cursor:pointer; }
  .err { color:#b00020; white-space:pre-wrap; }
  h2 { font-size:15px; }
</style>
</head>
<body>
<header>
  <h1>pinot-tpu</h1>
  <nav>
    <a data-tab="tables" class="active">Tables</a>
    <a data-tab="instances">Instances</a>
    <a data-tab="metrics">Metrics</a>
    <a data-tab="query">Query Console</a>
  </nav>
</header>
<main id="main"></main>
<script>
const $ = (h) => { const d = document.createElement('div'); d.innerHTML = h; return d; };
const main = document.getElementById('main');
const get = async (p) => (await fetch(p)).json();
let tab = 'tables';

document.querySelectorAll('nav a').forEach(a => a.onclick = () => {
  tab = a.dataset.tab;
  document.querySelectorAll('nav a').forEach(x => x.classList.toggle('active', x === a));
  render();
});

async function render() {
  if (tab === 'tables') return renderTables();
  if (tab === 'instances') return renderInstances();
  if (tab === 'metrics') return renderMetrics();
  if (tab === 'query') return renderQuery();
}

async function renderTables() {
  const { tables } = await get('/tables');
  let rows = '';
  for (const t of tables) {
    const segs = await get('/tables/' + t + '/segments').catch(() => ({segments: []}));
    const n = (segs.segments || []).length;
    rows += `<tr class="clickable" onclick="showTable('${t}')"><td>${t}</td><td>${n}</td></tr>`;
  }
  main.replaceChildren($(`<h2>Tables</h2><table><tr><th>name</th><th>segments</th></tr>${rows}</table><div id="detail"></div>`));
}

window.showTable = async function(t) {
  const [cfg, segs, ideal] = await Promise.all([
    get('/tables/' + t), get('/tables/' + t + '/segments'), get('/tables/' + t + '/idealstate'),
  ]);
  document.getElementById('detail').innerHTML =
    `<h2>${t} — config</h2><pre>${JSON.stringify(cfg, null, 1)}</pre>` +
    `<h2>segments</h2><pre>${JSON.stringify(segs, null, 1)}</pre>` +
    `<h2>ideal state</h2><pre>${JSON.stringify(ideal, null, 1)}</pre>`;
};

async function renderInstances() {
  const [inst, brokers] = await Promise.all([get('/instances'), get('/brokers')]);
  main.replaceChildren($(
    `<h2>Servers</h2><pre>${JSON.stringify(inst, null, 1)}</pre>` +
    `<h2>Brokers</h2><pre>${JSON.stringify(brokers, null, 1)}</pre>`));
}

async function renderMetrics() {
  const m = await get('/metrics?format=json');
  main.replaceChildren($(`<h2>Controller metrics</h2><pre>${JSON.stringify(m, null, 1)}</pre>`));
}

async function renderQuery() {
  main.replaceChildren($(
    `<h2>Query Console</h2>
     <p style="font-size:12px">runs against the first registered broker (/brokers)</p>
     <textarea id="sql">SELECT * FROM mytable LIMIT 10</textarea><br>
     <button onclick="runQuery()">Run</button>
     <div id="qout"></div>`));
}

window.runQuery = async function() {
  const out = document.getElementById('qout');
  try {
    const brokers = await get('/brokers');
    const url = Object.values(brokers)[0];
    if (!url) { out.innerHTML = '<p class="err">no brokers registered</p>'; return; }
    const sql = document.getElementById('sql').value;
    const resp = await fetch(url + '/query/sql', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({ sql }),
    });
    const doc = await resp.json();
    if (doc.exceptions) { out.innerHTML = `<p class="err">${JSON.stringify(doc.exceptions)}</p>`; return; }
    const rt = doc.resultTable;
    const head = rt.dataSchema.columnNames.map(c => `<th>${c}</th>`).join('');
    const body = rt.rows.map(r => `<tr>${r.map(v => `<td>${JSON.stringify(v)}</td>`).join('')}</tr>`).join('');
    out.innerHTML = `<table><tr>${head}</tr>${body}</table>
      <p style="font-size:12px">${doc.numDocsScanned} docs scanned · ${Math.round(doc.timeUsedMs)} ms</p>`;
  } catch (e) { out.innerHTML = `<p class="err">${e}</p>`; }
};

render();
</script>
</body>
</html>"""
