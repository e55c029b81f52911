"""YAML config + dotted overrides.  Counterpart of
wenet_tpu/utils/config.py."""

import copy

import yaml


def override_config(configs, override_list):
    """Apply 'a.b.c value' dotted overrides."""
    new_configs = copy.deepcopy(configs)
    for item in override_list:
        arr = item.split()
        if len(arr) != 2:
            print(f"the overrive {item} format not correct, skip it")
            continue
        keys = arr[0].split('.')
        s_configs = new_configs
        for i, key in enumerate(keys):
            if i == len(keys) - 1:
                old = s_configs.get(key, None)
                if isinstance(old, bool):
                    v = arr[1].lower() in ('true', '1')
                elif isinstance(old, int):
                    v = int(arr[1])
                elif isinstance(old, float):
                    v = float(arr[1])
                elif isinstance(old, list):
                    v = yaml.safe_load(arr[1])
                else:
                    v = arr[1]
                s_configs[key] = v
                print(f"override {arr[0]} with {arr[1]}")
            else:
                s_configs = s_configs.setdefault(key, {})
    return new_configs


def load_config(path, overrides=None):
    with open(path) as f:
        configs = yaml.load(f, Loader=yaml.FullLoader)
    if overrides:
        configs = override_config(configs, overrides)
    return configs


def save_config(configs, path):
    with open(path, 'w') as f:
        yaml.dump(configs, f, default_flow_style=False)
