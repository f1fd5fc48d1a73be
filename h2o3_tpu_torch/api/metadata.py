"""Schema metadata endpoints — the SchemaServer surface.

The port's copy of h2o3_tpu/api/metadata.py, over the port server's
route table (``api/server.ROUTES``).

Reference: water/api/SchemaServer.java (schema registry),
water/api/MetadataHandler.java (/3/Metadata/endpoints, /3/Metadata/schemas),
water/api/schemas3/CloudV3.java (field list served to H2OCluster).

The real h2o-py client cannot even connect without these: on connect it
calls define_classes_from_schema for H2OCluster / H2OErrorV3 /
H2OModelBuilderErrorV3, each of which GETs /3/Metadata/schemas/{name} and
turns the returned field list into python properties
(h2o-py/h2o/schemas/schema.py:28, h2o-py/h2o/backend/connection.py:679).
Serving the right field names IS the wire contract.
"""

from __future__ import annotations

from typing import Dict, List


def _fields(*names: str, schema: Dict[str, str] | None = None) -> List[dict]:
    """Field descriptors: name + is_schema flag + help text."""
    schema = schema or {}
    return [{"name": n, "is_schema": n in schema,
             "schema_name": schema.get(n),
             "type": "Iced", "help": n.replace("_", " ")}
            for n in names]


# Field lists mirror the reference schema classes (water/api/schemas3/*.java)
# — names only; the client builds properties from them.
SCHEMAS: Dict[str, List[dict]] = {
    "CloudV3": _fields(
        "version", "branch_name", "last_commit_hash", "describe",
        "compiled_by", "compiled_on", "build_number", "build_age",
        "build_too_old", "node_idx", "cloud_name", "cloud_size",
        "cloud_uptime_millis", "cloud_internal_timezone",
        "datafile_parser_timezone", "cloud_healthy", "bad_nodes",
        "consensus", "locked", "is_client", "nodes",
        "internal_security_enabled", "web_ip",
        schema={"nodes": "NodeV3"}),
    "H2OErrorV3": _fields(
        "timestamp", "error_url", "msg", "dev_msg", "http_status",
        "values", "exception_type", "exception_msg", "stacktrace"),
    "H2OModelBuilderErrorV3": _fields(
        "timestamp", "error_url", "msg", "dev_msg", "http_status",
        "values", "exception_type", "exception_msg", "stacktrace",
        "parameters", "messages", "error_count",
        schema={"parameters": "ModelParametersSchemaV3"}),
    "NodeV3": _fields(
        "h2o", "ip_port", "healthy", "last_ping", "pid", "num_cpus",
        "cpus_allowed", "nthreads", "sys_load", "my_cpu_pct",
        "sys_cpu_pct", "mem_value_size", "pojo_mem", "free_mem",
        "max_mem", "swap_mem", "num_keys", "free_disk", "max_disk",
        "rpcs_active", "fjthrds", "fjqueue", "tcps_active", "open_fds",
        "gflops", "mem_bw"),
    "TwoDimTableV3": _fields(
        "name", "description", "columns", "rowcount", "data"),
    "FrameV3": _fields(
        "frame_id", "byte_size", "is_text", "row_offset", "row_count",
        "column_offset", "column_count", "full_column_count",
        "total_column_count", "checksum", "rows", "num_columns",
        "default_percentiles", "columns", "compatible_models",
        "chunk_summary", "distribution_summary",
        schema={"frame_id": "FrameKeyV3"}),
    "JobV3": _fields(
        "key", "description", "status", "progress", "progress_msg",
        "start_time", "msec", "dest", "warnings", "exception",
        "stacktrace", "ready_for_view",
        schema={"key": "JobKeyV3", "dest": "KeyV3"}),
    "ModelSchemaV3": _fields(
        "model_id", "algo", "algo_full_name", "parameters", "output",
        "compatible_frames", "have_pojo", "have_mojo", "timestamp",
        schema={"model_id": "ModelKeyV3"}),
    "RapidsSchemaV3": _fields("ast", "session_id", "id"),
    "InitIDV3": _fields("session_key"),
}


def register(route):
    """Attach handlers onto the server's route table (called by server.py
    at import time so ROUTES stays a single registry)."""

    @route("GET", r"/3/Metadata/schemas/(?P<name>[^/]+)")
    def _schema_meta(params, body, name=None):
        fields = SCHEMAS.get(name)
        if fields is None:
            # Unknown schemas yield an empty field list rather than a 404:
            # the client treats absent fields as "property not available".
            fields = []
        return {
            "__meta": {"schema_version": 3, "schema_name": "MetadataV3",
                       "schema_type": "Metadata"},
            "schemas": [{"name": name, "superclass": "Schema",
                         "version": 3, "type": "Iced",
                         "fields": fields, "markdown": ""}],
            "routes": [],
        }

    @route("GET", "/3/Metadata/schemas")
    def _schemas_all(params, body):
        return {
            "__meta": {"schema_version": 3, "schema_name": "MetadataV3",
                       "schema_type": "Metadata"},
            "schemas": [{"name": n, "superclass": "Schema", "version": 3,
                         "type": "Iced", "fields": f, "markdown": ""}
                        for n, f in SCHEMAS.items()],
            "routes": [],
        }

    @route("GET", "/3/Metadata/endpoints")
    def _endpoints(params, body):
        from h2o3_tpu_torch.api.server import ROUTES
        routes = []
        for method, rx, fn in ROUTES:
            pat = rx.pattern.strip("^$")
            routes.append({
                "http_method": method,
                "url_pattern": pat,
                "summary": (fn.__doc__ or "").strip().split("\n")[0],
                "api_name": fn.__name__.strip("_"),
                "input_schema": "Iced", "output_schema": "Iced",
                "path_params": rx.groupindex and list(rx.groupindex) or [],
            })
        return {
            "__meta": {"schema_version": 3, "schema_name": "MetadataV3",
                       "schema_type": "Metadata"},
            "schemas": [], "routes": routes,
        }
