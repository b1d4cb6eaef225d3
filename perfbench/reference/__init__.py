"""The plain reference of the benchmark: Social Ways' generator,
discriminator, training step, K-sample forecast and crowd simulation in
plain PyTorch, written from the model's equations (arXiv:1904.09507 and
the reference ``train.py``), with nothing of the program under test.

Every tensor is float32.  A ``Precision`` says where a value is rounded:
to the model's activation dtype after each operation that stores one
(``store``), and the operands of every product (``mm``).  float32 rounds
nothing; bfloat16 rounds at the program's mixed-precision cast points;
the lower precisions (TF32, float8) are the controls that the comparison
has to refuse.
"""
