"""monopsr_torch.config (a YAML reader of the subset the configs use,
without PyYAML) against the JAX package's config module and
yaml.safe_load."""

import os

import pytest
import yaml

from monopsr_tpu import config as jax_config
from monopsr_torch import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION = os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')


def test_production_config_parses_as_in_jax(tmp_path):
    got = config.parse_yaml_config(PRODUCTION, str(tmp_path))
    want = jax_config.parse_yaml_config(PRODUCTION, str(tmp_path))
    assert got.to_dict() == want.to_dict()
    # derived fields aside, the raw document agrees with PyYAML's
    assert config.load_yaml(PRODUCTION) == yaml.safe_load(open(PRODUCTION))
    assert got.train_config.optimizer.adam_optimizer.initial_learning_rate \
        == 0.00008
    assert got.dataset_config.seed is None
    assert got.model_config.metrics_to_show[3] == ['metric_cen_z_err', 'std']
    # default outputs root: <repo>/data/outputs, as in the JAX package
    assert config.parse_yaml_config(PRODUCTION).exp_output_dir == \
        jax_config.parse_yaml_config(PRODUCTION).exp_output_dir


SNIPPETS = [
    "a: 1\nb: -2\nc: +3\nd: 0\n",
    "x: 0.00008\ny: 1.5e+3\nz: .5\nw: 2.\nv: -0.25\n",
    "t: True\nf: False\nl: true\nu: FALSE\n",
    "n: !!null\nm: null\nk: ~\ne:\n",
    "s: 'plain'  # comment\nq: 'it''s # not a comment'\nh: '#x' #c\n",
    "# a comment line\n\nouter:   # after a key\n    inner:\n        leaf: 3\n"
    "    other: 'o'\nnext: 4\n",
    "lst: [0.2, 0.2, 0.2]\nints: [5, 45]\nstrs: ['Car']\nempty: []\n",
    "nested: [\n    ['metric_chamfer', 'avg'],  # one\n"
    "    ['metric_emd', 'avg'],\n]\n",
    "mixed: [1, 'two', 3.0, True, null, [4, [5]]]\n",
    "  indented_top: 1\n  second: [1,2]\n",
]


@pytest.mark.parametrize('text', SNIPPETS)
def test_reader_agrees_with_safe_load(text):
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize('text,where', [
    ("a: 1\nb: 2\na: 3\n", 3),                 # duplicate key
    ("o:\n  k: 1\n  k: 2\n", 3),               # duplicate nested key
    ("a: yes\n", 1),                           # YAML 1.1 bool word
    ("a: plain words\n", 1),                   # unquoted string
    ('a: "double"\n', 1),
    ("a:\n  - 1\n  - 2\n", 2),                 # block sequence
    ("a: {b: 1}\n", 1),                        # flow mapping
    ("a: &anchor 1\n", 1),
    ("a: !!str 1\n", 1),
    ("a: [1, !!null]\n", 1),                   # tags inside a flow list
    ("a: |\n  text\n", 1),                     # block scalar
    ("a: [1, 2\nb: 3\n", 1),                   # unclosed list
    ("a: 1\n\tb: 2\n", 2),                     # tab indentation
    ("a: 1\n   b: 2\n", 2),                    # bad indentation
    ("a: 007\n", 1),                           # YAML 1.1 octal
    ("a: 1e-4\n", 1),                          # PyYAML: a string
    ("a: 'open\n", 1),
    ("---\na: 1\n", 1),
])
def test_reader_refuses_outside_the_subset(text, where):
    with pytest.raises(config.YamlSubsetError, match=':{}:'.format(where)):
        config.parse_yaml(text)


def test_duplicate_key_in_file_names_the_line(tmp_path):
    path = tmp_path / 'dup.yaml'
    path.write_text("train_config:\n    max_iterations: 1\n"
                    "    max_iterations: 2\n")
    with pytest.raises(config.YamlSubsetError,
                       match='dup.yaml:3: found duplicate key'):
        config.parse_yaml_config(str(path))
    with pytest.raises(Exception):             # the JAX package refuses too
        jax_config.parse_yaml_config(str(path))


def test_copy_config_into_experiment_dir_backs_up_on_drift(tmp_path):
    src = tmp_path / 'exp.yaml'
    src.write_text("a: 1\n")
    cfg = config.parse_yaml_config(str(src), str(tmp_path / 'out'))
    dst = config.copy_config_into_experiment_dir(str(src), cfg)
    assert open(dst).read() == "a: 1\n"
    src.write_text("a: 2\n")
    config.copy_config_into_experiment_dir(str(src), cfg)
    names = os.listdir(cfg.exp_output_dir)
    assert open(dst).read() == "a: 2\n"
    assert any(n.startswith('exp.yaml.bak.') for n in names)
