"""Model directories by name.  Counterpart of wenet_tpu/cli/hub.py for
local directories only: an existing directory, then
$WENET_TPU_MODEL_HOME/<name> (default ~/.wenet/<name>) with a train.yaml.
Where the JAX package would download a model the port raises with the
JAX package's message: it has no downloader (place the extracted model
directory there)."""

import os

MODEL_HOME = os.environ.get('WENET_TPU_MODEL_HOME',
                            os.path.expanduser('~/.wenet'))


class Hub:

    @staticmethod
    def get_model_by_lang(lang: str) -> str:
        mapping = {'chinese': 'wenetspeech', 'english': 'gigaspeech'}
        if lang not in mapping:
            raise ValueError(f'unsupported language {lang}')
        return Hub.download_model(mapping[lang])

    @staticmethod
    def download_model(name: str) -> str:
        """`name` if it is a directory, else MODEL_HOME/name when it holds
        a train.yaml; else FileNotFoundError."""
        if os.path.isdir(name):
            return name
        model_dir = os.path.join(MODEL_HOME, name)
        if os.path.isdir(model_dir) and \
                os.path.exists(os.path.join(model_dir, 'train.yaml')):
            return model_dir
        reason = 'downloading is not ported'
        raise FileNotFoundError(
            f'model "{name}" not found under {MODEL_HOME} and '
            f'download failed ({reason}); place the extracted model dir '
            f'(train.yaml + checkpoint) at {model_dir}')
