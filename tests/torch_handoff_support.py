"""Helpers shared by the real-engine handoff tests of the port
(test_torch_handoff_engine.py, test_torch_handoff_death.py): the
reference's tiny GPT trained on arithmetic sequences (so that greedy
completions vary), the port's twin with the same weights, fronts of
either package over them, and a pause at a fixed decode position."""
import numpy as np

V, S, B = 32, 16, 4
WIDTHS = dict(seq_length=S, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, vocab_size=V)
SLOTS, PAGE, POOL, CHUNK = 2, 4, 12, 4
FRONT_SEED = 5
WAIT_S = 30.0


def trained_pair():
    """(reference GPT after 40 SGD steps on arithmetic sequences, the
    port's GPT with its weights carried across)."""
    import jax

    import flexflow_tpu as J
    import flexflow_tpu_torch as T
    from flexflow_tpu.models.transformer import build_gpt as jax_gpt
    from flexflow_tpu_torch.models.transformer import build_gpt

    jf = J.FFModel(J.FFConfig(batch_size=B, num_devices=1))
    jax_gpt(jf, batch_size=B, **WIDTHS)
    jf.compile(optimizer=J.SGDOptimizer(lr=0.5),
               loss_type=J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               devices=jax.devices("cpu")[:1])
    rng = np.random.RandomState(0)
    start = rng.randint(0, V, (B, 1))
    step = rng.randint(1, 6, (B, 1))
    seq_ids = (start + step * np.arange(S + 1)) % V
    ids = seq_ids[:, :-1].astype(np.int32)
    labels = seq_ids[:, 1:].astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for _ in range(40):
        jf.train_step({"input": ids, "positions": pos}, labels)
    tf = T.FFModel(T.FFConfig(batch_size=SLOTS, device="cpu"))
    build_gpt(tf, batch_size=SLOTS, **WIDTHS)
    tf.compile(comp_mode=T.CompMode.INFERENCE)
    tf.set_weights(jf.get_weights())
    for cfg in (jf.config, tf.config):
        cfg.serving_slots = SLOTS
        cfg.kv_page_size = PAGE
        cfg.kv_pool_blocks = POOL
        cfg.prefill_chunk = CHUNK
    jf.config.paged_kernel = "gather"  # the reference's oracle read
    return jf, tf


def front_of(pkg: str, ff, **kw):
    """A 2-replica front of `pkg` ("ref" or "port") over ff, the pool's
    invariants checked after every step."""
    kw.setdefault("seed", FRONT_SEED)
    if pkg == "ref":
        import jax

        from flexflow_tpu.serving import ServingFront

        return ServingFront.from_trained(
            ff, num_replicas=2, devices=jax.devices("cpu")[:1],
            check_invariants=True, **kw)
    from flexflow_tpu_torch.serving import ServingFront

    return ServingFront.from_trained(ff, num_replicas=2,
                                     check_invariants=True, **kw)


def arm_pause(front, at: int):
    """Wrap every replica's engine step: the first decode step that
    feeds position `at` of a live row asks its replica to pause
    (request_handoff, KV exported), and the pause runs at that step's
    boundary, so `at` + 1 tokens are written.  Returns the re-arming
    callable."""
    armed = [False]

    for r in front.replicas:
        model = r.scheduler.model._model
        real = model.step

        def step(tokens, seq_lens, btab, _real=real, _r=r):
            out = _real(tokens, seq_lens, btab)
            hit = any(int(p) == at and np.asarray(row).any()
                      for p, row in zip(seq_lens, btab))
            if armed[0] and hit:
                armed[0] = False
                _r.request_handoff(remaining_over=0, export_kv=True)
            return out

        model.step = step

    def arm():
        armed[0] = True

    return arm


def run_sequential(front, requests, arm=None):
    """Each (prompt, max_new, temperature) alone through `front`, in
    order (the front mints each request's seed at admission), pausing
    it mid-decode when `arm` is given."""
    out = []
    for prompt, mnt, temp in requests:
        if arm is not None:
            arm()
        out.append(front.generate_async(prompt, mnt, temp).wait(WAIT_S))
    return out
