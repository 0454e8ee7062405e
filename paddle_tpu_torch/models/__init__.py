"""Model builders of the port (reference: the JAX package's models/).

Each builder appends ops to the current default_main_program (use
``framework.program_guard``) and returns the key output Variables."""
from paddle_tpu_torch.models import deepfm, lenet, resnet, seq2seq, transformer, vgg, word2vec  # noqa: F401
from paddle_tpu_torch.models.deepfm import deepfm_ctr  # noqa: F401
from paddle_tpu_torch.models.lenet import lenet5  # noqa: F401
from paddle_tpu_torch.models.resnet import resnet18, resnet50  # noqa: F401
from paddle_tpu_torch.models.seq2seq import transformer_nmt  # noqa: F401
from paddle_tpu_torch.models.transformer import bert_encoder, bert_pretrain, transformer_lm  # noqa: F401
from paddle_tpu_torch.models.vgg import vgg16  # noqa: F401
from paddle_tpu_torch.models.word2vec import word2vec_ngram  # noqa: F401
