"""Server status UI pages (weed/server/master_ui, volume_server_ui).

Plain HTML rendered from the same data the JSON endpoints expose.

The port's copy of ``seaweedfs_tpu/server/ui.py``: the same pages.
"""

from __future__ import annotations

import html

from .. import __version__

_STYLE = """
<style>
body { font-family: monospace; margin: 2em; }
table { border-collapse: collapse; margin: 1em 0; }
td, th { border: 1px solid #999; padding: 4px 10px; text-align: left; }
h1 { color: #2a6; } h2 { color: #555; }
</style>
"""


def _page(title: str, body: str) -> str:
    return (
        f"<html><head><title>{html.escape(title)}</title>{_STYLE}"
        f"</head><body><h1>{html.escape(title)}</h1>"
        f"<p>seaweedfs-tpu {__version__}</p>{body}</body></html>"
    )


def master_ui(topo_info: dict, leader_url: str) -> str:
    rows = []
    for dc in topo_info["data_centers"]:
        for rack in dc["racks"]:
            for dn in rack["data_nodes"]:
                rows.append(
                    f"<tr><td>{html.escape(dc['id'])}</td>"
                    f"<td>{html.escape(rack['id'])}</td>"
                    f"<td><a href='http://{dn['url']}/ui'>"
                    f"{html.escape(dn['id'])}</a></td>"
                    f"<td>{dn['volume_count']}"
                    f"/{dn['max_volume_count']}</td>"
                    f"<td>{dn['ec_shard_count']}</td></tr>"
                )
    body = (
        f"<h2>Cluster</h2><p>leader: {html.escape(leader_url)} · "
        f"max volume id: {topo_info['max_volume_id']}</p>"
        "<table><tr><th>Data Center</th><th>Rack</th><th>Node</th>"
        "<th>Volumes</th><th>EC shards</th></tr>"
        + "".join(rows)
        + "</table>"
        "<p><a href='/metrics'>metrics</a> · "
        "<a href='/debug/traces'>traces</a> · "
        "<a href='/debug/slow'>slow requests</a> · "
        "<a href='/debug/stacks'>stacks</a> · "
        "<a href='/debug/vars'>vars</a> · "
        "<a href='/debug/profile?seconds=5'>profile</a> · "
        "<a href='/debug/timeline?seconds=60'>timeline</a> · "
        "<a href='/debug/contention'>contention</a> · "
        "<a href='/debug/devices'>devices</a></p>"
    )
    return _page("SeaweedFS-TPU Master", body)


def volume_ui(status: dict, url: str) -> str:
    vol_rows = [
        f"<tr><td>{v['id']}</td>"
        f"<td>{html.escape(v.get('collection', ''))}</td>"
        f"<td>{v['size']}</td><td>{v['file_count']}</td>"
        f"<td>{v['delete_count']}</td><td>{v['read_only']}</td></tr>"
        for v in status.get("Volumes", [])
    ]
    ec_rows = [
        f"<tr><td>{e['id']}</td>"
        f"<td>{html.escape(e.get('collection', ''))}</td>"
        f"<td>{bin(e['ec_index_bits'])}</td></tr>"
        for e in status.get("EcShards", [])
    ]
    body = (
        f"<h2>Volumes on {html.escape(url)}</h2>"
        "<table><tr><th>Id</th><th>Collection</th><th>Size</th>"
        "<th>Files</th><th>Deleted</th><th>ReadOnly</th></tr>"
        + "".join(vol_rows)
        + "</table><h2>EC shards</h2>"
        "<table><tr><th>Id</th><th>Collection</th><th>Shards</th></tr>"
        + "".join(ec_rows)
        + "</table>"
        "<p><a href='/metrics'>metrics</a> · "
        "<a href='/debug/traces'>traces</a> · "
        "<a href='/debug/slow'>slow requests</a> · "
        "<a href='/debug/stacks'>stacks</a> · "
        "<a href='/debug/vars'>vars</a> · "
        "<a href='/debug/profile?seconds=5'>profile</a> · "
        "<a href='/debug/timeline?seconds=60'>timeline</a> · "
        "<a href='/debug/contention'>contention</a> · "
        "<a href='/debug/devices'>devices</a></p>"
    )
    return _page("SeaweedFS-TPU Volume Server", body)
