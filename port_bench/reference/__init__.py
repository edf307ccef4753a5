"""Plain PyTorch references of the benchmark's configurations: float32,
no kernels, no cache, no batching. They import neither JAX nor the JAX
package nor the program (`vila_tpu_torch`), and take nothing the program
made: weights are drawn again from the seed (`port_bench.weights`) and
every quantized value is worked out again from them."""
