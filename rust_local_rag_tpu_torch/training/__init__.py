"""Model training of the port (port of rust_local_rag_tpu/training/): the
InfoNCE encoder trainer (train_encoder, on parallel/train.py's mesh step)
and the yes/no reranker trainer (train_reranker), with their data: the
corpus harvester (corpus), contrastive and prompt pair batchers (pairs,
train_reranker.PromptPairBatcher), dense and junk mining (mining),
paraphrases (paraphrase) and out-of-domain junk queries (ood).

Both trainers write checkpoints that the port's serving stack and the JAX
package's loaders read. The WordPiece vocabulary trainer (training/tok.py
there) is not ported: it is built on the ``tokenizers`` package.
"""
