"""Models of the port: the GPT decoder, and the BERT and ERNIE encoders
(ResNet lives in ``vision/models``)."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel,
                   BertPretrainingCriterion, bert_base, bert_tiny)
from .ernie import (ErnieConfig, ErnieForSequenceClassification, ErnieModel,
                    ernie_3_0_10b, ernie_base, ernie_tiny)
from .gpt import (GPTConfig, GPTForCausalLM, GPTKVCache, GPTModel,
                  GPTStackedTransformer,
                  GPTPretrainingCriterion,
                  gpt2_large, gpt2_medium, gpt2_small, gpt3_1p3b, gpt_tiny)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTKVCache", "GPTModel",
           "GPTStackedTransformer",
           "GPTPretrainingCriterion",
           "gpt2_large", "gpt2_medium", "gpt2_small", "gpt3_1p3b",
           "gpt_tiny", "BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "BertPretrainingCriterion",
           "bert_tiny", "bert_base", "ErnieConfig", "ErnieModel",
           "ErnieForSequenceClassification", "ernie_tiny", "ernie_base",
           "ernie_3_0_10b"]
