"""Graph serialization: a GraphDef-like JSON document and the meta graph;
the port of ``simple_tensorflow_tpu/framework/graph_io.py`` (ref:
tensorflow/python/framework/{graph_io,importer,meta_graph}.py), with the
same wire format, so either package imports what the other wrote.

A graph is ``{"versions", "node": [...]}``; a node holds its name, op
type, input tensor names, control inputs, device, attrs and output specs
(shape and dtype name). Attrs are JSON values, or ``{"__kind__": ...}``
objects: ``ndarray`` (an ``.npy`` payload in base64), ``strlist``,
``dtype``, ``shape``, ``tuple``, ``funcgraph`` (a nested graph function:
its nodes, inputs, outputs and captures) and ``repr``. A meta graph adds
the graph's collections: tensors and ops by name, and objects with a
``to_proto`` (a ``Variable`` as its variable, initializer, snapshot and
initial-value names), which ``import_meta_graph`` rebinds
(``Variable.from_proto``) so a ``Saver`` finds the variables again.

Numpy scalar attrs are written as JSON numbers (the JAX package writes
their ``repr``, which neither package reads back as a number). The port's
ops record no creation site, so a node carries no ``source``.

A graph's constants can be large (the flat Adam slots' zero initial
values of ``TransformerConfig.big()``: 1.7 GB). :func:`export_meta_graph`
writes such a document without passing the payloads through the JSON
encoder: the document is encoded with a token in place of each array,
and each array's base64 is written in the token's place as the file is
written, one array at a time (the same text ``json.dump`` writes: base64
needs no escaping).
"""

from __future__ import annotations

import base64
import io as _io
import json
import logging
import os
import re
import secrets

import numpy as np

from . import dtypes as dtypes_mod
from . import graph as ops_mod
from . import tensor_shape as shape_mod

_log = logging.getLogger(__name__)


class _Deferred:
    """An array whose base64 payload is written when the file is."""

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = array


class _Base64Sink:
    """A file for ``np.lib.format.write_array``: what is written goes to
    ``out`` base64-encoded, a multiple of 3 bytes at a time with the rest
    carried, so the text is ``base64.b64encode`` of the whole. numpy
    writes a large array in 16 MiB pieces, encoded here 3 MiB at a time:
    no call works on the whole array (a meta graph is written on the
    checkpoint writer thread, and one long call holds the GIL, the step
    loop with it)."""

    PIECE = 3 << 20   # a multiple of 3

    def __init__(self, out):
        self._out = out
        self._rest = b""

    def write(self, data):
        data = memoryview(self._rest + bytes(data))
        n = len(data) - len(data) % 3
        for lo in range(0, n, self.PIECE):
            self._out.write(base64.b64encode(data[lo:min(lo + self.PIECE,
                                                          n)]))
        self._rest = bytes(data[n:])

    def close(self):
        self._out.write(base64.b64encode(self._rest))


def _write_npy_base64(out, v: np.ndarray) -> None:
    """``base64(np.save(v))`` written to ``out`` in pieces."""
    sink = _Base64Sink(out)
    np.lib.format.write_array(sink, np.asanyarray(v), allow_pickle=False)
    sink.close()


def _npy_base64(v: np.ndarray) -> bytes:
    buf = _io.BytesIO()
    _write_npy_base64(buf, v)
    return buf.getvalue()


def _encode_attr(v, defer=False):
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return {"__kind__": "strlist",
                    "v": [s.decode() if isinstance(s, bytes) else str(s)
                          for s in np.ravel(v)],
                    "shape": list(v.shape)}
        return {"__kind__": "ndarray",
                "v": _Deferred(v) if defer else _npy_base64(v).decode()}
    if isinstance(v, dtypes_mod.DType):
        return {"__kind__": "dtype", "v": v.name}
    if isinstance(v, shape_mod.TensorShape):
        return {"__kind__": "shape",
                "v": v.as_list() if v.rank is not None else None}
    if isinstance(v, ops_mod.FuncGraph):
        return {"__kind__": "funcgraph", "v": _funcgraph_to_dict(v, defer)}
    if isinstance(v, (tuple, list)):
        return {"__kind__": "tuple",
                "v": [_encode_attr(x, defer) for x in v]}
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return {"__kind__": "repr", "v": repr(v)}


def _decode_attr(v):
    if isinstance(v, dict) and "__kind__" in v:
        kind = v["__kind__"]
        if kind == "ndarray":
            return np.load(_io.BytesIO(base64.b64decode(v["v"])),
                           allow_pickle=False)
        if kind == "strlist":
            return np.asarray(v["v"], dtype=object).reshape(v["shape"])
        if kind == "dtype":
            return dtypes_mod.as_dtype(v["v"])
        if kind == "shape":
            return shape_mod.TensorShape(v["v"])
        if kind == "tuple":
            return tuple(_decode_attr(x) for x in v["v"])
        if kind == "funcgraph":
            return v  # rebuilt by the importer
        if kind == "repr":
            return v["v"]
    return v


def _node_to_dict(op: ops_mod.Operation, defer=False):
    return {
        "name": op.name,
        "op": op.type,
        "input": [t.name for t in op.inputs],
        "control_input": [c.name for c in op.control_inputs],
        "device": "",
        "attr": {k: _encode_attr(v, defer) for k, v in op.attrs.items()},
        "output_specs": [
            [o.shape.as_list() if o.shape.rank is not None else None,
             o.dtype.name] for o in op.outputs],
    }


def _funcgraph_to_dict(fg: ops_mod.FuncGraph, defer=False):
    return {
        "name": fg.func_name,
        "node": [_node_to_dict(op, defer) for op in fg.get_operations()],
        "inputs": [t.name for t in fg.inputs],
        "outputs": [t.name for t in fg.outputs],
        # an imported body's captures have no outer tensor (the calling
        # op's inputs bind them)
        "captures": [[outer.name if outer is not None else None,
                      inner.name] for outer, inner in fg.captures],
    }


def graph_to_graphdef(graph: ops_mod.Graph, from_version=None,
                      defer=False):
    """(ref: Graph.as_graph_def, core/framework/graph.proto). ``defer``:
    arrays left for :func:`_write_json` to encode."""
    return {"versions": {"producer": 1},
            "node": [_node_to_dict(op, defer)
                     for op in graph.get_operations()]}


def _write_json(path, doc) -> None:
    """``json.dump(doc)`` into ``path``, each deferred array's base64
    written in place of a token, one array at a time."""
    token = f"@@stf_array_{secrets.token_hex(8)}_"
    arrays = []

    def default(o):
        if isinstance(o, _Deferred):
            arrays.append(o.array)
            return f"{token}{len(arrays) - 1}@@"
        raise TypeError(f"{type(o).__name__} is not JSON serializable")

    text = json.dumps(doc, default=default)
    parts = re.split(re.escape(token) + r"(\d+)@@", text)
    with open(path, "wb") as f:
        for i, part in enumerate(parts):
            if i % 2:
                _write_npy_base64(f, arrays[int(part)])
            else:
                f.write(part.encode("ascii"))


def write_graph(graph_or_graph_def, logdir, name, as_text=True):
    """(ref: python/framework/graph_io.py:28 ``write_graph``)."""
    if isinstance(graph_or_graph_def, ops_mod.Graph):
        gd = graph_to_graphdef(graph_or_graph_def)
    else:
        gd = graph_or_graph_def
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, name)
    with open(path, "w") as f:
        json.dump(gd, f, indent=1 if as_text else None)
    return path


def _build_nodes_into(target_graph, nodes, tensor_env, scope_prefix,
                      input_map=None):
    """Rebuild node dicts into ``target_graph`` (``import_graph_def`` and
    :func:`rebuild_funcgraph`)."""
    input_map = input_map or {}
    for node in nodes:
        attrs = {k: _decode_attr(v)
                 for k, v in (node.get("attr") or {}).items()}
        # a scoped import gets its own store names: an imported 'w' must
        # not alias this graph's 'w' (store keys come from these attrs)
        if scope_prefix:
            if isinstance(attrs.get("var_name"), str):
                attrs["var_name"] = f"{scope_prefix}/{attrs['var_name']}"
            if isinstance(attrs.get("var_names"), tuple):
                attrs["var_names"] = tuple(
                    f"{scope_prefix}/{n}" for n in attrs["var_names"])
        for k, v in list(attrs.items()):
            if isinstance(v, dict) and v.get("__kind__") == "funcgraph":
                attrs[k] = rebuild_funcgraph(v["v"], target_graph)
        inputs = [input_map[ref] if ref in input_map else tensor_env[ref]
                  for ref in node["input"]]
        ctrl = [tensor_env["(op)" + c]
                for c in node.get("control_input", ())
                if "(op)" + c in tensor_env]
        # a producer that omits output specs gets the registry's inference
        specs_raw = node.get("output_specs")
        specs = None if specs_raw is None else [
            (shape_mod.TensorShape(sh), dtypes_mod.as_dtype(dt))
            for sh, dt in specs_raw]
        new_name = f"{scope_prefix}/{node['name']}" if scope_prefix \
            else node["name"]
        op = target_graph.create_op(
            node["op"], inputs, attrs=attrs, name=new_name + "/",
            output_specs=specs, control_inputs=ctrl)
        tensor_env["(op)" + node["name"]] = op
        for i, out in enumerate(op.outputs):
            tensor_env[f"{node['name']}:{i}"] = out
    return tensor_env


def rebuild_funcgraph(fg_dict, outer):
    """A serialized FuncGraph rebuilt as a FuncGraph of ``outer``. Its
    captures keep their inner placeholders with no outer tensor: the
    calling op's inputs bind them."""
    fg = ops_mod.FuncGraph(fg_dict["name"], outer_graph=outer)
    env = {}
    with ops_mod._as_current(fg):
        _build_nodes_into(fg, fg_dict["node"], env, "")
    fg.inputs = [env[n] for n in fg_dict["inputs"]]
    fg.outputs = [env[n] for n in fg_dict["outputs"]]
    fg.captures = [(None, env[inner]) for _, inner in fg_dict["captures"]]
    return fg


def import_graph_def(graph_def, input_map=None, return_elements=None,
                     name=None, op_dict=None, producer_op_list=None):
    """(ref: python/framework/importer.py:156 ``import_graph_def``): the
    nodes rebuilt into the default graph, under the prefix ``name``
    ("import" by default, none for "")."""
    if isinstance(graph_def, (str, bytes)):
        graph_def = json.loads(graph_def)
    g = ops_mod.get_default_graph()
    prefix = "import" if name is None else name
    tensors = {}
    _build_nodes_into(g, graph_def["node"], tensors, prefix,
                      input_map=dict(input_map or {}))
    if return_elements:
        out = []
        for r in return_elements:
            key = r if ":" in r else "(op)" + r
            out.append(tensors[key] if key in tensors else tensors[f"{r}:0"])
        return out
    return None


def export_meta_graph(filename=None, graph=None, collection_list=None,
                      **kwargs):
    """(ref: python/framework/meta_graph.py ``export_scoped_meta_graph``):
    the graph, its collections and meta info. Returns the document; with
    ``filename`` writes it there instead (array by array, module
    docstring) and returns None, where the JAX package returns the
    document either way."""
    graph = graph or ops_mod.get_default_graph()
    meta = {"graph_def": graph_to_graphdef(graph, defer=bool(filename)),
            "collections": {},
            "meta_info": {"stf_version": "1.0.0-tpu"}}
    keys = collection_list if collection_list is not None \
        else list(graph._collections)
    for key in keys:
        names = []
        for it in graph.get_collection(key):
            if isinstance(it, ops_mod.Tensor):
                names.append({"tensor": it.name})
            elif isinstance(it, ops_mod.Operation):
                names.append({"op": it.name})
            elif hasattr(it, "to_proto"):
                names.append({"proto": it.to_proto()})
        if names:
            meta["collections"][key] = names
    if not filename:
        return meta
    _write_json(filename, meta)
    return None


def import_meta_graph(meta_graph_or_file, clear_devices=False,
                      import_scope=None):
    """Rebuild a meta graph (a file or its dict) into the default graph:
    its nodes (no prefix unless ``import_scope``) and collections."""
    if isinstance(meta_graph_or_file, str):
        with open(meta_graph_or_file) as f:
            meta = json.load(f)
    else:
        meta = meta_graph_or_file
    import_graph_def(meta["graph_def"], name=import_scope or "")
    _rebuild_collections(meta, import_scope)
    return meta


def _rebuild_collections(meta, import_scope=None):
    """The graph's collections from a meta graph, ``Variable`` objects
    rebound to the imported ops (ref: meta_graph.py
    ``import_scoped_meta_graph``: without them a Saver finds no
    variable)."""
    from ..ops.variables import Variable

    g = ops_mod.get_default_graph()
    rebuilt = {}

    def _scoped(name):
        return f"{import_scope}/{name}" if import_scope else name

    for key, items in meta.get("collections", {}).items():
        for it in items:
            if "tensor" in it or "op" in it:
                ref, as_tensor = ((it["tensor"], True) if "tensor" in it
                                  else (it["op"], False))
                try:
                    g.add_to_collection(key, g.as_graph_element(
                        _scoped(ref), allow_tensor=as_tensor,
                        allow_operation=not as_tensor))
                except (KeyError, ValueError):
                    continue  # not in the imported graph
            elif "proto" in it:
                proto = it["proto"]
                if not (isinstance(proto, dict)
                        and "variable_name" in proto):
                    continue  # a SaverDef: a new Saver takes its place
                vname = proto["variable_name"]
                if vname not in rebuilt:
                    try:
                        rebuilt[vname] = Variable.from_proto(
                            proto, import_scope=import_scope, graph=g)
                    except (KeyError, ValueError) as e:
                        # a Saver would skip it without a word
                        _log.warning(
                            "import_meta_graph: variable %s of collection "
                            "%s not rebuilt (%s); a Saver will not restore "
                            "it.", vname, key, e)
                        continue
                g.add_to_collection(key, rebuilt[vname])
