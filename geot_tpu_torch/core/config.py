"""Configs, device choice, the flagship model and training arguments, and
the model registry.

``EasyConfig`` is ``geot_tpu/core/config.py:19``'s layered config with
attribute access. The card's machine has no ``yaml`` package, so the port
reads and writes the YAML that ``cfgs/`` uses with its own code
(``load_yaml`` / ``dump_yaml``): block mappings and sequences, one-line
flow lists and mappings, anchors and aliases, comments, quoted scalars,
and plain scalars resolved as ``yaml.safe_load`` resolves them. Any other
construct raises ``ValueError`` naming its line.

``FLAGSHIP_SEG_ARGS`` is a plain dict copy of ``model.segmentor_args`` in
``cfgs/tooth_semi/transformer_finetune_fixmatch_ntm.yaml``, and
``FLAGSHIP_SEMI_CFG`` of the keys the semi-supervised step reads, from that
file merged over ``cfgs/tooth_semi/default.yaml``.
"""
from __future__ import annotations

import math
import os
import re
from ast import literal_eval
from typing import Any, Dict, List, Tuple

import torch

from .registry import Registry

FLAGSHIP_SEG_ARGS: Dict[str, Any] = {
    "NAME": "PointTransformer_seg_T",
    "pretrained_path": None,
    "trans_dim": 384,
    "depth": 12,
    "num_heads": 4,
    "group_size": 32,
    "num_group": 512,
    "encoder_dims": 256,
    "nclasses": 17,
    "drop_path_rate": 0.1,
    "downsample_targets": [8192, 4096, 2048],
    "extract_layers": [4, 8, 12],
}


FLAGSHIP_SEMI_CFG: Dict[str, Any] = {
    "num_classes": 17,
    "num_points": 16000,
    "seed": 1609,
    "epochs": 300,
    "lr": 0.001,
    "optimizer": {"NAME": "adamw", "weight_decay": 1.0e-4},
    "sched": "multistep",
    "decay_epochs": [220],
    "decay_rate": 0.1,
    "warmup_epochs": 0,
    "grad_norm_clip": 1,
    "criterion_args": {"NAME": "Poly1FocalLoss"},
    "criterion_u_args": {"NAME": "Poly1FocalLoss_U_corr"},
    "threshold": 0.0,
    "unsupervised_loss_weight": 1.0,
    "lambma": 0.9,
    "geo_lambma": 0.999,
    "ema_t_decay": 0.999,
    "filter_outlier": False,
    "use_3d_loss": True,
    "threed_loss_weight": 0.1,
    "threed_k": 32,
    "threed_sigma": 1.0,
    "batch_size_l": 2,
    "batch_size_u": 2,
    "switch_ep": 50,
    "supervised_epochs": 0,
    "t_predictor": {"NAME": "Ins_T_mean",
                    "T_args": {"NAME": "sig_t_mean", "nclasses": 17}},
    "datatransforms": {
        "train": ["PointsToTensor", "PointCloudScaling",
                  "PointCloudCenterAndNormalize"],
        "train_w": ["PointsToTensor", "PointCloudCenterAndNormalize"],
        "train_s": ["PointsToTensor", "PointCloudScaling_s",
                    "PointCloudCenterAndNormalize", "PointCloudRotation_s",
                    "PointCloudTranslation_s"],
        "val": ["PointsToTensor", "PointCloudCenterAndNormalize"],
        "test": ["PointsToTensor", "PointCloudCenterAndNormalize"],
        "vote": ["PointCloudScaling"],
        "kwargs": {"jitter_sigma": 0.001, "jitter_clip": 0.005,
                   "scale": [0.9, 1.1], "gravity_dim": 1,
                   "shift": [0.1, 0.1, 0.1], "angle": [0.5, 0.5, 0.5],
                   "jitter_sigma_s": 0.001, "jitter_clip_s": 0.005,
                   "scale_s": [0.8, 1.2], "shift_s": [0.2, 0.2, 0.2],
                   "angle_s": [1, 1, 1]},
    },
}


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller names the
    CPU; asking for CUDA without a card raises instead of running on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


# the model registry (geot_tpu/models/build.py:9); the classes register
# themselves with ``@MODELS.register_module(name=...)``
MODELS = Registry("models")


def build_model_from_cfg(cfg: Dict[str, Any],
                         **default_args: Any) -> torch.nn.Module:
    """Build the model named by ``cfg["NAME"]`` with the remaining keys
    over ``default_args`` as arguments (``geot_tpu/models/build.py:12``;
    ``pretrained_path`` is a loader concern and is dropped)."""
    from .. import models  # noqa: F401  (registers the model classes)

    cfg = {k: v for k, v in dict(cfg).items() if k != "pretrained_path"}
    return MODELS.build(cfg, **default_args)


# --- YAML ------------------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1), ``yaml/resolver.py``
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)
                   |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                     |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                     |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$""", re.X)
# forms safe_load resolves to types this reader does not build
_UNSUPPORTED = re.compile(r"""^(?:
    [-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
    |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt\ ].*)?
    |<<|=)$""", re.X)
_KEY = re.compile(r"""^((?:'[^']*'|"[^"\\]*"|[^\s'"\[\]{}#&*!|>%@`,?:-]
                  |-(?=\S))(?:[^:#]|:(?=\S)|(?<=\S)\#)*?)[ ]*:(?:[ ]+(.*))?$""",
                  re.X)


class _Lines:
    """The significant lines of a document: (line number, indent, text)
    with comments and trailing blanks removed."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.rows: List[Tuple[int, int, str]] = []
        for n, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if body.startswith("\t") or "\t" in raw[:len(raw) - len(body)]:
                self.fail(n, "tab in indentation")
            body = _strip_comment(body, lambda msg: self.fail(n, msg))
            if not body:
                continue
            if body.startswith(("---", "...", "%")):
                self.fail(n, "directives and multiple documents are not "
                          "supported")
            self.rows.append((n, len(raw) - len(raw.lstrip(" ")), body))

    def fail(self, line: int, msg: str):
        raise ValueError(f"{self.name}:{line}: {msg}")


def _strip_comment(body: str, fail) -> str:
    """``body`` up to a ``#`` that starts a comment (at the start, or after
    a blank, outside quotes)."""
    quote = None
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or body[i - 1] in " [{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or body[i - 1] == " "):
            return body[:i].rstrip()
    if quote:
        fail("unterminated quoted scalar")
    return body.rstrip()


def _scalar(text: str, fail) -> Any:
    """A plain or quoted scalar, resolved as ``yaml.safe_load`` does."""
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            fail(f"bad quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"' or "\\" in text:
            fail(f"unsupported double-quoted scalar {text!r}")
        return text[1:-1]
    if text[:1] in ("!", "|", ">", "%", "@", "`", "?") or text[:2] in (
            "- ",) or ": " in text or text.endswith(":"):
        fail(f"unsupported construct {text!r}")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _UNSUPPORTED.match(text):
        fail(f"unsupported scalar {text!r}")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.endswith(".inf"):
            return -math.inf if v[0] == "-" else math.inf
        if v.endswith(".nan"):
            return math.nan
        return float(v)
    return text


def _flow(text: str, fail) -> Any:
    """A one-line flow list or mapping."""
    pos = 0

    def blank():
        nonlocal pos
        while pos < len(text) and text[pos] == " ":
            pos += 1

    def node(stop: str):
        nonlocal pos
        blank()
        if pos < len(text) and text[pos] in "[{":
            close = "]" if text[pos] == "[" else "}"
            out: Any = [] if close == "]" else {}
            pos += 1
            while True:
                blank()
                if pos >= len(text):
                    fail(f"unclosed flow collection {text!r}")
                if text[pos] == close:
                    pos += 1
                    return out
                if close == "]":
                    out.append(node(",]"))
                else:
                    key = node(",:}")
                    blank()
                    val = None
                    if pos < len(text) and text[pos] == ":":
                        pos += 1
                        val = node(",}")
                    out[key] = val
                blank()
                if pos < len(text) and text[pos] == ",":
                    pos += 1
                elif pos >= len(text) or text[pos] != close:
                    fail(f"bad flow collection {text!r}")
        start = pos
        if pos < len(text) and text[pos] in "'\"":
            end = text.find(text[pos], pos + 1)
            if end < 0:
                fail(f"unterminated quoted scalar in {text!r}")
            pos = end + 1
        else:
            while pos < len(text) and text[pos] not in stop:
                if text[pos] in "[]{}":
                    fail(f"bad flow collection {text!r}")
                pos += 1
        return _scalar(text[start:pos].strip(), fail)

    value = node("")
    blank()
    if pos != len(text):
        fail(f"text after a flow collection: {text!r}")
    return value


class _Parser:
    def __init__(self, lines: _Lines):
        self.rows = lines.rows
        self.fail_at = lines.fail
        self.anchors: Dict[str, Any] = {}
        self.i = 0

    def parse(self) -> Any:
        if not self.rows:
            return None
        value = self.block(self.rows[0][1])
        if self.i < len(self.rows):
            self.fail_at(self.rows[self.i][0], "bad indentation")
        return value

    def block(self, indent: int) -> Any:
        text = self.rows[self.i][2]
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        if _KEY.match(text):
            return self.mapping(indent)
        line = self.rows[self.i][0]
        self.i += 1
        return self.inline(text, line)

    def nested(self, indent: int, line: int, seq_ok: bool) -> Any:
        """The block under a key or dash at ``indent``: deeper lines, or a
        sequence at the same indent under a mapping key."""
        if self.i < len(self.rows):
            _, ind, text = self.rows[self.i]
            if ind > indent or (seq_ok and ind == indent and (
                    text == "-" or text.startswith("- "))):
                return self.block(ind)
        return None

    def value(self, rest: str, indent: int, line: int, seq_ok: bool) -> Any:
        anchor = None
        if rest.startswith("&"):
            anchor, _, rest = rest[1:].partition(" ")
            rest = rest.strip()
        if rest:
            val = self.inline(rest, line)
        else:
            val = self.nested(indent, line, seq_ok)
        if anchor:
            self.anchors[anchor] = val
        return val

    def inline(self, text: str, line: int) -> Any:
        def fail(msg):
            self.fail_at(line, msg)

        if text.startswith("*"):
            if text[1:] not in self.anchors:
                fail(f"unknown alias {text!r}")
            return self.anchors[text[1:]]
        if text.startswith("&"):
            fail(f"unsupported anchor placement {text!r}")
        if text[:1] in "[{":
            return _flow(text, fail)
        return _scalar(text, fail)

    def mapping(self, indent: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while self.i < len(self.rows):
            line, ind, text = self.rows[self.i]
            if ind < indent:
                break
            if ind > indent:
                self.fail_at(line, "bad indentation")
            m = _KEY.match(text)
            if not m:
                self.fail_at(line, f"expected 'key: value', got {text!r}")
            key = self.inline(m.group(1).strip(), line)
            self.i += 1
            out[key] = self.value((m.group(2) or "").strip(), indent, line,
                                  seq_ok=True)
        return out

    def sequence(self, indent: int) -> List[Any]:
        out: List[Any] = []
        while self.i < len(self.rows):
            line, ind, text = self.rows[self.i]
            if ind < indent:
                break
            if ind > indent or not (text == "-" or text.startswith("- ")):
                if ind == indent and _KEY.match(text):
                    break                  # the parent mapping's next key
                self.fail_at(line, "bad indentation")
            rest = text[1:].lstrip(" ")
            if rest and not rest.startswith(("&", "*")) and (
                    _KEY.match(rest) or rest == "-"
                    or rest.startswith("- ")):
                # a compact mapping or sequence: the rest of the line is the
                # first line of a block at the column where it starts
                col = ind + len(text) - len(rest)
                self.rows[self.i] = (line, col, rest)
                out.append(self.block(col))
                continue
            self.i += 1
            out.append(self.value(rest, indent, line, seq_ok=False))
        return out


def load_yaml(text: str, name: str = "<yaml>") -> Any:
    """Parse the YAML subset described in the module docstring."""
    return _Parser(_Lines(text, name)).parse()


_PLAIN = re.compile(r"^[A-Za-z_/][A-Za-z0-9_./,+-]*$")


def _raise(msg: str):
    raise ValueError(msg)


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if "\n" in v:
            raise ValueError(f"multi-line string {v!r} is not supported")
        if _PLAIN.match(v) and _scalar(v, _raise) == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def dump_yaml(data: Any, indent: int = 0) -> str:
    """``data`` (dicts, lists and scalars) as YAML that ``load_yaml`` reads
    back to an equal value; mapping keys sorted, as ``yaml.dump`` does."""
    pad = " " * indent
    if isinstance(data, dict):
        if not data:
            return pad + "{}\n"
        out = []
        for k in sorted(data, key=str):
            v = data[k]
            key = _dump_scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:\n" + dump_yaml(v, indent + 2))
            elif isinstance(v, (list, tuple)) and any(
                    isinstance(x, (dict, list, tuple)) for x in v):
                out.append(f"{pad}{key}:\n" + dump_yaml(list(v), indent + 2))
            else:
                out.append(f"{pad}{key}: " + dump_yaml(v).lstrip(" "))
        return "".join(out)
    if isinstance(data, (list, tuple)):
        if not any(isinstance(x, (dict, list, tuple)) for x in data):
            return pad + "[" + ", ".join(_dump_scalar(x) for x in data) + "]\n"
        out = []
        for x in data:
            if isinstance(x, (dict, list, tuple)) and x:
                body = dump_yaml(x, indent + 2)
                out.append(f"{pad}- " + body[indent + 2:])
            else:
                out.append(f"{pad}- " + dump_yaml(x).lstrip(" "))
        return "".join(out)
    return pad + _dump_scalar(data) + "\n"


class EasyConfig(dict):
    """A dict with attribute access, loaded from YAML and updated from
    ``k=v`` overrides (``geot_tpu/core/config.py:19-115``)."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]

    def load(self, fpath: str, *, recursive: bool = False) -> None:
        """Merge ``fpath`` into this config; with ``recursive``, first every
        ``default.yaml`` of its parent directories, outermost first, so the
        named file wins."""
        if not os.path.exists(fpath):
            raise FileNotFoundError(fpath)
        fpaths = [fpath]
        if recursive:
            extension = os.path.splitext(fpath)[1]
            while os.path.dirname(fpath) != fpath:
                fpath = os.path.dirname(fpath)
                fpaths.append(os.path.join(fpath, "default" + extension))
        for p in reversed(fpaths):
            if os.path.exists(p):
                with open(p) as f:
                    loaded = load_yaml(f.read(), p)
                if loaded:
                    self.update(loaded)

    def update(self, other: Any) -> None:  # type: ignore[override]
        """Merge a dict (nested dicts merge key by key), or apply a list of
        ``k=v`` / ``--k v`` overrides: dotted keys reach into nested
        configs, values go through ``ast.literal_eval`` where they parse."""
        if isinstance(other, dict):
            self._update_dict(other)
        elif isinstance(other, (list, tuple)):
            self._update_opts(list(other))
        else:
            raise TypeError(f"cannot update EasyConfig from {type(other)}")

    def _update_dict(self, other: Dict[str, Any]) -> None:
        for key, value in other.items():
            if isinstance(value, dict):
                if key not in self or not isinstance(self[key], EasyConfig):
                    self[key] = EasyConfig()
                self[key]._update_dict(value)
            else:
                self[key] = value

    def _update_opts(self, opts: List[str]) -> None:
        index = 0
        while index < len(opts):
            opt = opts[index]
            if opt.startswith("--"):
                opt = opt[2:]
            if "=" in opt:
                key, value = opt.split("=", 1)
                index += 1
            else:
                key, value = opt, opts[index + 1]
                index += 2
            try:
                value = literal_eval(value)
            except (ValueError, SyntaxError):
                pass
            current = self
            subkeys = key.split(".")
            for subkey in subkeys[:-1]:
                current = current.setdefault(subkey, EasyConfig())
            current[subkeys[-1]] = value

    def dict(self) -> Dict[str, Any]:
        """A plain nested dict copy."""
        return {k: v.dict() if isinstance(v, EasyConfig) else v
                for k, v in self.items()}
