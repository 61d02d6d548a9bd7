"""YAML experiment configuration, read without PyYAML.

Counterpart of ``monopsr_tpu/config.py``: nested maps become attribute
namespaces, duplicate keys are rejected, and the experiment identity is
the config file basename; output locations derive from
``data/outputs/<config_name>/``.

The JAX package parses with PyYAML, which the card's machine lacks. Here
a reader of the YAML subset that ``configs/monopsr_model_000.yaml`` uses
takes its place:

- block mappings by indentation (spaces only), keys ``[A-Za-z_]\\w*``;
- ``#`` comments at a line's start or after whitespace, outside quotes;
- single-quoted strings (``''`` for a quote), ints, floats in YAML 1.1's
  form (``0.00008``, ``1.5e+3``), ``True``/``False`` (and lower/upper
  case), ``!!null``/``null``/``~`` and an empty value for None;
- flow lists ``[0.2, 0.2]`` of those (without tags: ``null`` there),
  nested and over several lines, with an optional trailing comma.

Values resolve as PyYAML's ``safe_load`` resolves them. Anything else
(plain unquoted strings, double quotes, block sequences, flow mappings,
anchors, tags other than ``!!null``, block scalars, tabs) raises
``YamlSubsetError`` with the file and line.
"""

import os
import re
import shutil
import time

import monopsr_torch


class ConfigObj:
    """A plain attribute namespace built from a nested dict.

    Nested dicts become nested ConfigObj instances; lists and scalars are
    stored as-is. Attribute access on a missing key raises AttributeError.
    """

    def __init__(self, entries=None):
        if entries:
            for key, value in entries.items():
                setattr(self, key, _convert(value))

    def __repr__(self):
        return 'ConfigObj({})'.format(self.__dict__)

    def __eq__(self, other):
        if not isinstance(other, ConfigObj):
            return NotImplemented
        return self.__dict__ == other.__dict__

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def to_dict(self):
        out = {}
        for key, value in self.__dict__.items():
            out[key] = value.to_dict() if isinstance(value, ConfigObj) else value
        return out


def _convert(value):
    if isinstance(value, dict):
        return ConfigObj(value)
    return value


# --------------------------------------------------------------------------
# The YAML subset
# --------------------------------------------------------------------------

class YamlSubsetError(ValueError):
    """A construct outside the YAML subset this reader takes, or a
    duplicate key."""


_KEY = re.compile(r'[A-Za-z_][A-Za-z0-9_]*$')
_INT = re.compile(r'[-+]?(0|[1-9][0-9]*)$')
_FLOAT = re.compile(r'([-+]?[0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$')
_BOOLS = {'True': True, 'true': True, 'TRUE': True,
          'False': False, 'false': False, 'FALSE': False}
_NULLS = ('!!null', 'null', 'Null', 'NULL', '~')


def _fail(where, lineno, msg):
    raise YamlSubsetError('{}:{}: {}'.format(where, lineno, msg))


def _strip_comment(line, where, lineno):
    """The line without its comment; quotes must close on the line."""
    quoted = False
    i = 0
    while i < len(line):
        ch = line[i]
        if quoted:
            if ch == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1                          # '' inside quotes
                else:
                    quoted = False
        elif ch == "'":
            quoted = True
        elif ch == '"':
            _fail(where, lineno, 'double-quoted strings are not supported')
        elif ch == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
        i += 1
    if quoted:
        _fail(where, lineno, 'unterminated single-quoted string')
    return line.rstrip()


def _bracket_depth(text):
    depth, quoted = 0, False
    for ch in text:
        if ch == "'":
            quoted = not quoted        # '' toggles twice: depth unchanged
        elif not quoted:
            depth += (ch == '[') - (ch == ']')
    return depth


def _scalar(text, where, lineno):
    if text.startswith("'"):
        body = text[1:-1]
        if len(text) < 2 or not text.endswith("'") or "'" in body.replace(
                "''", ''):
            _fail(where, lineno, 'malformed quoted string: ' + text)
        return body.replace("''", "'")
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    _fail(where, lineno, 'unsupported value (quote strings): ' + text)


def _flow_list(text, pos, where, lineno):
    """Parses the list opening at text[pos]: (list, position after it)."""
    items = []
    pos += 1
    while True:
        while pos < len(text) and text[pos] == ' ':
            pos += 1
        if pos >= len(text):
            _fail(where, lineno, 'unclosed flow list')
        if text[pos] == ']':
            return items, pos + 1
        if text[pos] == '[':
            item, pos = _flow_list(text, pos, where, lineno)
        else:
            start, quoted = pos, False
            while pos < len(text) and (quoted or text[pos] not in ',]'):
                if text[pos] == "'":
                    quoted = not quoted
                pos += 1
            token = text[start:pos].strip()
            if not token:
                _fail(where, lineno, 'empty flow list item')
            if token[0] in '{&*!|>':      # (PyYAML reads "!!null]" as a
                _fail(where, lineno,         # tag, so no tags in lists)
                      'unsupported flow item: ' + token)
            item = _scalar(token, where, lineno)
        items.append(item)
        while pos < len(text) and text[pos] == ' ':
            pos += 1
        if pos < len(text) and text[pos] == ',':
            pos += 1
        elif pos >= len(text) or text[pos] != ']':
            _fail(where, lineno, 'expected "," or "]" in flow list')


def _value(text, where, lineno):
    if text.startswith('['):
        items, end = _flow_list(text, 0, where, lineno)
        if text[end:].strip():
            _fail(where, lineno, 'text after a flow list: ' + text[end:])
        return items
    if text[0] in '{&*|>' or (text[0] == '!' and text not in _NULLS):
        _fail(where, lineno, 'unsupported construct: ' + text)
    return _scalar(text, where, lineno)


def _logical_lines(text, where):
    """(line number, indent, content) per non-blank line, comments
    stripped, a flow list's continuation lines joined to its first."""
    raw = text.split('\n')
    out = []
    i = 0
    while i < len(raw):
        lineno = i + 1
        line = raw[i]
        lead = line[:len(line) - len(line.lstrip(' \t'))]
        if '\t' in lead:
            _fail(where, lineno, 'tab in indentation')
        content = _strip_comment(line, where, lineno)
        i += 1
        if not content.strip():
            continue
        indent = len(content) - len(content.lstrip(' '))
        content = content.strip()
        if content in ('---', '...'):
            _fail(where, lineno, 'document markers are not supported')
        while _bracket_depth(content) > 0:
            if i >= len(raw):
                _fail(where, lineno, 'unclosed flow list')
            content += ' ' + _strip_comment(raw[i], where, i + 1).strip()
            i += 1
        if _bracket_depth(content) < 0:
            _fail(where, lineno, 'unbalanced "]"')
        out.append((lineno, indent, content))
    return out


def _block(lines, pos, indent, where):
    """The mapping of the lines at ``indent`` from ``pos``: (dict, next
    position)."""
    mapping = {}
    while pos < len(lines):
        lineno, line_indent, content = lines[pos]
        if line_indent < indent:
            break
        if line_indent > indent:
            _fail(where, lineno, 'unexpected indentation')
        key, sep, rest = content.partition(':')
        if not sep or not _KEY.match(key) or (rest and rest[0] != ' '):
            _fail(where, lineno, 'expected "key: value" or "key:"')
        if key in mapping:
            _fail(where, lineno, 'found duplicate key ({})'.format(key))
        value = rest.strip()
        pos += 1
        if value:
            mapping[key] = _value(value, where, lineno)
        elif pos < len(lines) and lines[pos][1] > indent:
            mapping[key], pos = _block(lines, pos, lines[pos][1], where)
        else:
            mapping[key] = None
    return mapping, pos


def parse_yaml(text, where='<string>'):
    """Parses YAML text of the subset above into nested dicts and lists
    (None for an empty document)."""
    lines = _logical_lines(text, where)
    if not lines:
        return None
    mapping, pos = _block(lines, 0, lines[0][1], where)
    if pos != len(lines):
        _fail(where, lines[pos][0], 'unexpected indentation')
    return mapping


def load_yaml(path):
    with open(path, 'r') as f:
        return parse_yaml(f.read(), path)


def _dump_scalar(value, in_list):
    if value is None:
        return 'null' if in_list else '!!null'
    if isinstance(value, bool):
        return 'True' if value else 'False'
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        text = repr(value)
        if not _FLOAT.match(text):     # '1e-05' -> '1.0e-05'; 3 -> '3.0'
            mantissa, e, exponent = text.partition('e')
            if '.' not in mantissa:
                mantissa += '.0'
            if e and exponent[0] not in '+-':
                exponent = '+' + exponent
            text = mantissa + e + exponent
        if not _FLOAT.match(text):     # inf, nan
            raise YamlSubsetError('no YAML subset form for ' + repr(value))
        return text
    if isinstance(value, str):
        if '\n' in value or '\r' in value:
            raise YamlSubsetError('multi-line string: ' + repr(value))
        return "'{}'".format(value.replace("'", "''"))
    if isinstance(value, (list, tuple)):
        return '[{}]'.format(', '.join(_dump_scalar(v, True) for v in value))
    raise YamlSubsetError('no YAML subset form for {!r}'.format(value))


def _dump_block(mapping, indent, out):
    for key, value in mapping.items():
        if not isinstance(key, str) or not _KEY.match(key):
            raise YamlSubsetError('unsupported key: {!r}'.format(key))
        if isinstance(value, dict):
            if not value:
                raise YamlSubsetError('empty mapping under ' + key)
            out.append('{}{}:'.format(' ' * indent, key))
            _dump_block(value, indent + 2, out)
        else:
            out.append('{}{}: {}'.format(' ' * indent, key,
                                         _dump_scalar(value, False)))


def dump_yaml(obj, path):
    """Writes a nested dict in the subset ``parse_yaml`` reads (block
    mappings, single-quoted strings, ``!!null``, flow lists), so that
    ``load_yaml(path)`` returns an equal dict; the writer that takes
    the place of PyYAML's ``safe_dump``. Raises YamlSubsetError for a
    value the subset cannot hold (a mapping inside a list, an empty
    mapping, a multi-line string, inf or nan)."""
    out = []
    _dump_block(obj, 0, out)
    with open(path, 'w') as f:
        f.write('\n'.join(out) + '\n')


def parse_yaml_config(yaml_path, output_base_dir=None):
    """Parses a YAML config file into a ConfigObj and derives output paths.

    Args:
        yaml_path: path to the YAML config file.
        output_base_dir: optional override for the outputs root
            (defaults to <repo>/data/outputs).

    Returns:
        config: ConfigObj with `dataset_config`, `model_config`,
            `train_config` sections plus derived fields:
            `config_name`, `exp_output_dir`, `checkpoint_dir`, `logdir`,
            `pred_dir`, `checkpoint_name`.
    """
    config = ConfigObj(load_yaml(yaml_path))

    config_name = os.path.splitext(os.path.basename(yaml_path))[0]
    config.config_name = config_name

    if output_base_dir is None:
        output_base_dir = os.path.join(monopsr_torch.data_dir(), 'outputs')

    exp_output_dir = os.path.join(output_base_dir, config_name)
    config.exp_output_dir = exp_output_dir
    config.checkpoint_dir = os.path.join(exp_output_dir, 'checkpoints')
    config.logdir = os.path.join(exp_output_dir, 'logs')
    config.pred_dir = os.path.join(exp_output_dir, 'predictions')

    # Checkpoint name matches the config name
    config.checkpoint_name = config_name

    return config


def copy_config_into_experiment_dir(yaml_path, config):
    """Freezes the config into the experiment dir, backing up on drift:
    if a config copy exists and differs from the current file, the old
    one is moved aside with a timestamp before being replaced."""
    os.makedirs(config.exp_output_dir, exist_ok=True)
    dst = os.path.join(config.exp_output_dir, os.path.basename(yaml_path))

    if os.path.exists(dst):
        with open(yaml_path, 'rb') as f_new, open(dst, 'rb') as f_old:
            if f_new.read() != f_old.read():
                backup = dst + '.bak.{}'.format(int(time.time()))
                shutil.move(dst, backup)
                shutil.copyfile(yaml_path, dst)
    else:
        shutil.copyfile(yaml_path, dst)

    return dst
