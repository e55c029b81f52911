"""FireRed-AED checkpoint -> the reference wenet keys of this package's
`FireRedModel`.  Counterpart of wenet_tpu/models/firered/convert.py (its
module names, layer_stack/mhsa/ffn1/..., mapped onto the conformer and
decoder names):

    python -m wenet_tpu_torch.models.firered.convert \\
        --firered_model model.pth.tar --output_dir exp/firered
"""

import argparse
import os
from typing import Dict

_RENAMES = [
    ('input_preprocessor', 'embed'),
    ('encoder.embed.out', 'encoder.embed.out.0'),
    ('decoder.token_embedding', 'decoder.embed.0'),
    ('encoder.layer_stack', 'encoder.encoders'),
    ('decoder.layer_stack', 'decoder.decoders'),
    ('.cross_attn.w_qs', '.src_attn.linear_q'),
    ('.cross_attn.w_ks', '.src_attn.linear_k'),
    ('.cross_attn.w_vs', '.src_attn.linear_v'),
    ('.cross_attn.fc', '.src_attn.linear_out'),
    ('.self_attn.w_qs', '.self_attn.linear_q'),
    ('.self_attn.w_ks', '.self_attn.linear_k'),
    ('.self_attn.w_vs', '.self_attn.linear_v'),
    ('.self_attn.fc', '.self_attn.linear_out'),
    ('.mhsa.w_qs', '.self_attn.linear_q'),
    ('.mhsa.w_ks', '.self_attn.linear_k'),
    ('.mhsa.w_vs', '.self_attn.linear_v'),
    ('.mhsa.fc', '.self_attn.linear_out'),
    ('.mhsa.pos_bias_u', '.self_attn.pos_bias_u'),
    ('.mhsa.pos_bias_v', '.self_attn.pos_bias_v'),
    ('.mhsa.linear_pos', '.self_attn.linear_pos'),
    ('.mlp.', '.feed_forward.'),
    ('.ffn1.net.1', '.feed_forward_macaron.w_1'),
    ('.ffn1.net.4', '.feed_forward_macaron.w_2'),
    ('.ffn2.net.1', '.feed_forward.w_1'),
    ('.ffn2.net.4', '.feed_forward.w_2'),
    ('.self_attn_norm.', '.norm1.'),
    ('.cross_attn_norm.', '.norm2.'),
    ('.mlp_norm.', '.norm3.'),
    ('.ffn1.net.0.', '.norm_ff_macaron.'),
    ('.mhsa.layer_norm_q.', '.self_attn.layer_norm_q.'),
    ('.mhsa.layer_norm_k.', '.self_attn.layer_norm_k.'),
    ('.mhsa.layer_norm_v.', '.self_attn.layer_norm_v.'),
    ('.conv.pre_layer_norm.', '.norm_conv.'),
    ('.ffn2.net.0', '.norm_ff'),
    ('.layer_norm.', '.norm_final.'),
]


def convert_state_dict(sd: Dict) -> Dict:
    out = {}
    for name, w in sd.items():
        for old, new in _RENAMES:
            name = name.replace(old, new)
        if 'embed' not in name:
            name = name.replace('.conv.', '.conv_module.')
            name = name.replace('.batch_norm.', '.norm.')
        if 'decoder' in name:
            name = name.replace('cross_attn_ln', 'norm2')
            name = name.replace('mlp_ln', 'norm3')
        else:
            name = name.replace('mlp_ln', 'norm2')
        out[name] = w
    return out


def main():
    import torch
    p = argparse.ArgumentParser()
    p.add_argument('--firered_model', required=True)
    p.add_argument('--output_dir', required=True)
    args = p.parse_args()
    os.makedirs(args.output_dir, exist_ok=True)
    ckpt = torch.load(args.firered_model, map_location='cpu')
    sd = ckpt.get('model_state_dict', ckpt)
    torch.save(convert_state_dict(sd),
               os.path.join(args.output_dir, 'final.pt'))
    print('wrote', args.output_dir)


if __name__ == '__main__':
    main()
