#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--lm-only | --gnn-only]

``--lm-only`` runs the device phase and the LM phases (16) alone and
prints no result line; ``--gnn-only`` the device, build and gnn (17)
phases alone, with no result line either.

Phases, each printing one JSON line:
  1. device   — refuses to run without CUDA; prints the card's name and
                power limit as nvidia-smi reports them.
  2. build    — builds the hand-written kernels (csrc/*.cu, nvcc, sm_90a).
  3. kernels  — runs gather_dist and beam_hop at the main path's shapes,
                holds each against its plain PyTorch version (exact on
                integer-valued inputs, within tolerance on float inputs)
                and times both with CUDA events; then topk_merge at
                TOPK_SHAPES (the NSG pool assembly, the device finish's
                union, NN-Descent's merge) through each of its variants
                (warp, block), bit-equal to its plain version on integer
                and float rows, each variant's device_ms with its bound and
                share, then the rest of the default fit's widths (the
                random-projection joins, the subset seed, the AntiHub
                table's rounds, the table pools);
                then lut_dist (at R = 1, the pool seed, and R = 32) through
                each of its variants (warp, thread) and beam_hop in LUT mode
                at M = 300 (pq) and M = 600 (int8), which must equal their
                plain versions bit for bit on float inputs too (lut_dist
                also gives the 32-byte sectors its lookups touch);
                then l2topk at each of its shapes on the path (AntiHub,
                kNN, ground truth, k-means, medoid, entry-point select, PQ)
                and at FlatIndex's k = 256 over the raw base, exact on tied
                integer inputs, within rtol 1e-5 on float inputs, each
                through the variant L2TOPK_ROUTES names (tc: 3xTF32 on the
                tensor cores, tile: f32 SIMT tiles, small: the database in
                shared memory, wide: k past the tile lists), with its f32
                and 3xTF32 bounds; and beam_hops, the hop loop kernel, over a
                whole 1024-query search (f32, and LUT mode at M = 300 and
                600 on the persistent variant, also timed on per_query), which
                must equal the host loop over the one-hop kernel in every
                field and counter; a LUT shape route sends to per_query
                (M = 2048) must too. gather_dist, topk_merge, lut_dist and
                the hops also give device_ms (queued behind a device
                sleep, no host launch). Then gather_dist and beam_hops in
                the sharded tier's modes (bf16 rows, prenorm, both) at the
                hop-loop shape: bit-equal to their plain versions on normal
                data (the plain versions sum in the kernels' lane order),
                each mode's device ms beside its bound.
  4. fit      — builds TunedGraphIndex with the ann-laion config
                (knn_backend="exact", finish_backend="host") on
                clustered_vectors(300000, 768) from --seed (the config's
                N and width; only the seed is an option); every topk_pool
                of its pool assembly must take the variant topk_merge's
                route names (warp), and its two α-scans (the prune stage
                and the interconnect's re-prune) one alpha_scan launch per
                2048-row chunk each, all on the variant alpha_scan's
                route names (staged).
  5. serve    — 1024 queries, k=10, ef=64, fused hop: QPS, recall@10 against
                the exact top-10 in the raw space, the hop counters, and the
                brute-force QPS (the l2topk kernel over the raw vectors);
                per_search: the kernels one search launches (one beam_hops
                launch) and the hop loop's host syncs (one). The fit reports
                its launches and syncs too (one of each per pool chunk).
                At --seed 0 recall@10 must be the baseline's (BASELINE_SEED0).
  6. staged   — the same search with the staged hop must equal the fused one
                exactly (ids, dists, counters).
  7. reference — 256 of the queries searched again on the CPU, where every
                kernel runs its plain PyTorch version, must agree.
 7b. serve_compacted — the same index served through the compacted
                search (search(..., compact_every=)) at COMPACT_SETTINGS
                (16 hops with patience off, 8 with patience 8) against the
                uncompacted fused search at the same patience: ids, dists,
                hops, gathered and dup_gathered equal, wasted_hops no more,
                the slices' batch sizes powers of two that never grow, one
                host sync per slice; QPS of both (median of 7 batches of
                1024, in turns), launches and host syncs per search. Run in
                f32 here and after each quantized phase in its backend.
  8. quantized — for pq, then int8, on the index of phase 4: the codec's
                fit and encode seconds, then 1024 queries with k=10, ef=64,
                the config's rerank (64) and the fused LUT hop (QPS,
                recall@10, counters, device-busy share), every loop launch
                on the persistent variant and every pool seed's lut_dist on
                the variant its route names (warp); the staged search must
                equal it
                bit for bit, and 256 queries searched again on the CPU must
                agree.
 8b. fit_auto — ann-laion fitted with IndexParams.from_config(CONFIG)
                unmodified (NN-Descent for the AntiHub and structural kNN
                tables with the subset reuse, table pools, the device
                finish) on the phase-4 data: stage seconds (knn_seconds,
                interconnect / repair apart), both NN-Descent BuildStats,
                the kNN table's recall against an exact 32-NN of the same
                base (l2topk), pool and prune evals, repair rounds, reach
                steps (one host sync each), topk_merge's launches by mode
                and variant (all warp), recall@10 and QPS of the 1024
                queries at ef = 64 beside the exact/host fit's recall@10;
                every node must be reachable from the medoid, and both
                recalls must clear their floors (FIT_AUTO_*_FLOOR); one
                alpha_scan launch per chunk of each α-scan; at --seed 0 both
                recalls and the gather_dist launches must be the
                baseline's, less the launches of its per-position α-scan
                loop (one per candidate position of each chunk: 283 of
                21,403).
  8c. snapshot — run right after phase 8's pq search: save_index
                writes the exact/host index (its f32 copy) and its
                pq-quantized self to a temporary directory, load_index
                reads each back on the card (checksums verified,
                validate_index run); ids and distance bits over the 1024
                queries must equal the in-memory index's; snapshot
                bytes, save and load-and-validate seconds beside the fit's.
                A stepped directory whose newest step has a flipped byte
                must load the step before it (a small IVF index).
 9. tune     — the paper's tuner on the same data and queries: an
                AnnObjective (base: the config, graph_degree 32) with a TPE
                study of 8 trials over default_space's rebuild-free knobs
                (graph_degree, alpha, ep_clusters, ef_search, hop_backend,
                patience), the structural knobs held at the config's; it
                must make exactly one structural build and one family pass,
                every derived graph must be reachable from the medoid, and a
                repruned trial's graph must equal reprune_nsg's, id for id;
                the family pass, run again and timed alone
                (family_pass_seconds), must give the same packed masks.
 10. tune_cli — python -m repro_torch.launch.tune at N=20000, D=768 with
                its default backends (NN-Descent, table pools, the device
                finish; the full default_space: several structural builds)
                must exit 0 and print its Pareto front and build log.
10b. alpha_scan — the α-scan kernel on the operands fit_auto and the
                tuner gave it (recorded by ScanRecorder): the first and last
                chunk of the prune stage (B = 2048, L = 64), of the
                interconnect's re-prune (L = 96) and of the family pass
                (9 x 2048 rows, L = 32, one alpha per row); keep and mask
                of each variant (warp, staged) must equal the plain
                version's (on the card) exactly; ms, device_ms and share of
                bound of each variant (timed in turns), plain_ms and the
                bound of each first chunk; the variant each shape routes
                to, which every α-scan launch of the fits must have taken;
                core.nsg.mrng_prune on the prune stage's first chunk (one
                alpha_scan launch) bit-equal to alpha_prune at alpha = 1
                and to the plain scan ("mrng_prune" line).
10c. factory — the paper's Fig. 1 through the unified index API
                (build_index) on the phase-4 data and queries:
                FACTORY_SPECS (Flat, NSG24,EP1, IVF128,Flat at nprobe 8,
                PQ16, IVFPQ128x16 at nprobe 8) at 300k x 768 and
                HNSW16,Flat at ef 64 on the first HNSW_CUT = 5,000 rows
                ("cut"; its build is a host insert): fit seconds,
                recall@10, QPS (median of 7 batches of 1024), memory_bytes,
                device-busy share and each kernel's launches over one
                search; each family's search must launch its kernel
                (FAMILY_KERNEL) and reach its FACTORY_RECALL_FLOOR (Flat
                0.999, the others about a point under their readings); the
                first gather_dist, lut_dist and l2topk call of the IVF, PQ
                and IVF-PQ searches (FAMILY_CHECKED: the query chunk's
                probed ids, the ADC scan's first chunk, the centroid probe)
                runs again through its wrapper and its plain version on the
                same operands and must agree (factory_kernel_check); PQ16's
                ADC top-10, and IVFPQ128x16's with every list probed, must
                agree with the exact top-10 over the index's own
                reconstructions (factory_adc_check).
10d. sharded — ROADMAP item 9 on the phase-4 data: ShardedIndex over a
                mesh naming cuda:0 four times and StreamedShardedIndex, 4
                shards of 75k, each fit with IndexParams.from_config(CONFIG)
                from one seed (the mesh pads its shards to the most kept
                rows, the streamed tier to ceil(N / 4)); their graphs, their
                1024-query searches (k = 10, ef = 64) and their
                reprune(alpha=1.2, degree=24) must be equal bit for bit
                (a refit that differs fails the phase); recall@10 against
                the exact top-10 in the raw space, fit seconds per shard,
                QPS (median of 7), launches per search (4 beam_hops and 4
                host syncs) and per reprune (one alpha_scan per 1024-row
                block of each shard); shard 0's search for 256 queries
                again on the CPU; make_sharded_l2_topk equal to FlatIndex;
                PQ16 row-sharded on the first 40k rows (lut_dist); and a
                Flat ShardedFactoryIndex with shard 0 dead under
                on_shard_error="skip", equal to the exact top-10 over
                shards 1-3. Every kernel of SHARDED_KERNELS must launch.
10e. streamed — StreamedShardedIndex at 1.2M x 768 (4 shards of the
                config's 300k): vectors generated on the card, the exact
                top-10 taken there, moved to host memory before the fit;
                fit seconds, QPS, recall@10, the store's pinned bytes, the
                search's peak device memory (at most two shards' blocks plus
                the batch's own tensors, and below the store: asserted), one
                shard's host-to-device copy beside one shard's search; then
                the same 1.2M fit once more under ANN_BF16_BASE: the store's
                bytes (its base exactly half of f32's: asserted), one
                shard's copy beside its search, QPS and recall@10.
10f. sharded_toggles — the 4 x 75k mesh and streamed tiers of 10d with
                each mode of the ANN toggles: bf16 rows (both tiers fit
                again under ANN_BF16_BASE), prenorm (the f32 tiers of 10d
                searched under ANN_PRENORM), and both: the tiers bit-equal
                (asserted), recall@10 over its floor, QPS (median of 7), the
                launches of gather_dist and beam_hops under the mode
                (by_mode, each above zero: asserted), the bf16 base's bytes
                half of f32's, and the bf16 tiers' reprunes bit-equal.
 11. recsys   — the two-tower retrieval model at its full config (a
                14,010,368 x 256 f32 table, 14.35 GB; no width or vocabulary
                cut) from --seed: recsys_score_step at B = 512 (median and
                p99 of 100 batches) and B = 262,144 (queries/s), then
                recsys_retrieval_step for 1 user x 1,000,000 candidates, top
                10. A serve_p99 batch (512 requests) scored again with the
                plain bag on the card (embedding_bag_ref) must give the same
                bits, and the retrieval the same top 10.
 12. recsys_ann — retrieval through the tuned index: the item tower's
                embeddings of items 0..299,999 (2M items cut to 300k: the
                exact kNN grows as N^2) as the database, the user tower's of
                1024 requests as the queries (ef_search 64, degree 16, 16
                entry points, exact kNN, host finish): fit seconds,
                recall@10 against FlatIndex and QPS.
 13. recsys_cli — python -m repro_torch.launch.serve --arch
                two-tower-retrieval, sasrec, din and dlrm-mlperf (four
                processes at once) must each exit 0 and print its line.
13b. serve_cli — python -m repro_torch.launch.serve --arch ann-laion with
                its defaults (bucketed, micro-batched), with --spec
                IVF64,Flat --buckets off --snapshot DIR, and with --restore
                DIR (no build; the same recall), then python -m
                repro_torch.launch.tune --spec IVF64,Flat; each line parsed,
                each recall@10 above its SERVE_CLI_RUNS floor (about a point
                under its reading); a launcher that prints a "resilience:"
                line (a failed ticket, a failed flush or a retry) fails the
                phase.
13c. sharded_cli — the launchers' --shards (SHARDED_CLI_RUNS): tune
                --shards 4 at N = 20k x 768 (one card: the streamed tier),
                the same under REPRO_ANN_BF16=1, tune --spec NSG16 --shards
                4, and serve --arch ann-laion --shards 4 --on-shard-error
                skip; each must exit 0 above its floor, the tune runs print
                "OK — one per shard", the serve run no resilience: and no
                degraded: line. new_phases gives the wall seconds of 8c,
                10c-10f, 13b, 13c and 14b.
 14. embedding_bag — the kernel against its plain version on small tables
                (f32 and bf16, D in {8, 18, 256}, both combiners, no, integer
                and float weights, and a weighted sum on a float32 midpoint:
                bit-equal), then at the path's three shapes over the full table
                bit-equal to the plain version on one id set each, and timed
                beside the plain version and torch's embedding_bag
                (ms: one event-timed call, host launch included; device_ms:
                16 calls queued back to back behind a device sleep, cycling
                the 8 id sets; device_ms_l2_warm: the same on one id set,
                whose rows stay in L2 at the small shapes).
14a. train   — recsys training. The two-tower model of phase 11 (the
                full 14.35 GB table) takes TRAIN_STEPS steps of
                make_train_step with mixed_optimizer(1e-3) (launch.train's
                optimizer) at B = 65,536 (RECSYS_SHAPES["train_batch"]):
                per step the loss, ms, peak device bytes and launches, one
                of embedding_bag's forward and one of its backward kernel
                each (asserted), and one more step under torch.profiler
                (device-busy share, top kernels); finite losses and every
                parameter moved (asserted). The backward kernel then reruns
                on the first step's operands (g, the history ids, mean)
                into a zero (V, D) gradient and must equal its plain
                version on the card bit for bit; it is timed beside the
                plain version, the (V, D) zero fill and torch's
                embedding_bag backward.
                Then SASRec and DIN at full config and DLRM with each table
                capped at DLRM_TRAIN_ROW_CAP = 2^23 rows (23.6 GB; a plain
                take), TRAIN_STEPS steps each at B = 65,536, launching no
                kernel (asserted); the Trainer with checkpoints on SASRec
                at full config (B = 4,096): 6 steps against 4, a restore and
                2 more, within TRAINER_TOL; and python -m
                repro_torch.launch.train for TRAIN_CLI_RUNS (two-tower's
                smoke config, SASRec's full config at B = 4,096), each
                exiting 0 with the reference's line.
14b. recsys_models — SASRec (a 1,000,448 x 50 table), DIN (1,010,176 x 18)
                and DLRM (CRITEO_VOCABS each capped at DLRM_ROW_CAP = 2^24
                rows: 87,950,080 padded rows x 128 f32, 45.0 GB; its lookup
                row-sharded over a mesh naming cuda:0 four times, held equal
                to a plain take) at their full configs from --seed: score
                ms at B = 512 (median and p99 of 100), bulk queries/s at B =
                262,144, 1 x 1,000,000 retrieval ms (DIN and DLRM over
                candidate chunks), table and peak bytes, and the card's
                scores for RECSYS_CPU_ROWS requests against the same model
                on the CPU (DLRM's rows fetched from the card's table).
                No kernel of the port lies on these paths (as none of the
                reference's Pallas kernels does on its own).
 16. lm_serve, lm_checks, lm_train, lm_cli — the dense LMs (ROADMAP
                item 10.6a), after 14b (printed before the kernels line).
                lm_serve, for qwen2-1.5b, mistral-nemo-12b and qwen3-32b
                at full width in bf16 from --seed: weight and peak bytes;
                check 1, prefill of LM_CHECK[0] tokens then LM_CHECK[1]
                greedy decode steps against forward over the sequence
                (relative RMS and largest logit difference within
                LM_BF16_REL / LM_BF16_MAX; ids equal but at ties within
                the measured difference); the prefill_32k and decode_32k
                cells at their LM_CUTS (batch, tokens) cuts: ms, tokens/s,
                peak bytes, bound (bf16 linear FLOP / 989 TFLOP/s plus
                causal f32 attention FLOP / 67 TFLOP/s; decode: weights
                and the valid KV read / 3.35 TB/s) and share, one layer's
                attention beside F.scaled_dot_product_attention at the
                prefill cell (a yardstick the port never calls), and a
                profiled decode step (LM_PROFILE_PREFILL's prefill too);
                long_500k skipped by skip_reason. lm_checks: check 2,
                attention above CHUNK_THRESHOLD against sdpa in f32 on the
                card (LM_ATTN_TOL); check 3, a 2-layer qwen2-1.5b at full
                width and vocabulary in f32 on the card against the CPU
                (LM_CPU_TOL). lm_train: qwen2-1.5b at full width, train_4k
                cut to LM_TRAINS (4 x 4,096 in 2 microbatches), 3 steps of
                adamw(3e-4) and one profiled: step ms, peak bytes, losses;
                finite losses and every parameter moved but those bf16
                rounding holds (asserted). lm_cli: launch.serve and
                launch.train --steps 2 for qwen2-1.5b exit 0 with the
                reference's lines. No kernel of the port launches in them
                (asserted).
                The MoE and MLA LMs (item 10.6b) run in the same phases:
                lm_serve takes deepseek-moe-16b at its full published size
                and deepseek-v2-236b cut in depth to LM_LAYERS' 8 of its 60
                layers (the dense one and 7 MoE: 58.38 GB of weights; the
                whole is 471.5 GB), both in bf16, the cells at LM_CUTS;
                check 1 runs there at capacity factor E / k
                (lm_check_config: no token can drop, so routing does not
                depend on which tokens share a group), counts the tokens
                bf16 rounding routed apart in the greedy run, and holds a
                second run routed to the forward's ids to the dense
                limits; the cells run at the published 1.25. The timed
                calls run with the routing log closed; the routing comes
                from one more untimed call on the same inputs. An MoE prefill
                reports each layer's per-expert pair counts and its
                dropped share, and its bound counts the active parameters
                (the capacity padding reported apart); an MoE decode
                step's bound reads the weights the step touches (every
                dense weight, and each routed expert the step's ids name,
                once) plus the valid cache; MLA's prefill attention FLOP is
                at the padded 192 width, its absorbed decode's at its
                latent form. lm_checks adds check 4, a 2-layer
                deepseek-moe-16b (1 dense + 1 MoE) at full width and
                vocabulary in f32, the card against the CPU (LM_CPU_TOL),
                and its MoE layer on integer-valued inputs (exact logits):
                routed ids and drop set equal; and check 5, the absorbed
                MLA decode against the rebuilding one at deepseek-v2's
                head shapes in f32 over LM_MLA_CHECK cached positions.
                lm_train adds deepseek-moe-16b at full width cut to 4 of
                its 28 layers (its aux loss beside the loss); lm_cli runs
                both launchers for both ids.
                lm_tp (after lm_train): qwen2-1.5b at full width in bf16
                tensor-parallel over meshes naming cuda:0 several times
                (sharding.shard_lm, mesh= on the steps): on LM_TP_SERVE's
                1 x 4 mesh a prefill of 1 x 8,192 and LM_TP_DECODE_STEPS
                greedy decode steps filling an 8 x 8,192 cache (2 KV heads do
                not divide 4: the cache split on sequence, the shards'
                softmaxes combined), on LM_TP_TRAIN's 2 x 2 mesh one
                adamw(3e-4) step of 4 x 1,024; each against the unsharded
                port on the same card and weights: logits within
                LM_BF16_REL / LM_BF16_MAX, the step's loss within
                LM_TP_LOSS_RTOL, every parameter finite and moved but those
                bf16 rounding holds; ms of each step, its collectives
                (calls and link bytes per device, from one counted run),
                the card's name and power limit. Then LM_TP_MOE
                (lm_tp_moe_run, its depth cuts on lm_tp_cut lines):
                deepseek-moe-16b (4 of 28 layers) and deepseek-v2-236b (3
                of 60) at full width, tensor- and expert-parallel
                (experts over model, the leading dense block's wo / w_down
                on their output columns, MLA's latent cache split on
                sequence): prefill LM_TP_PREFILL and LM_TP_MOE_DECODE_STEPS
                greedy decode steps on LM_TP_SERVE, the sharded runs routed
                to the unsharded runs' experts (their dropped pairs
                asserted equal), logits within LM_BF16_REL /
                LM_BF16_MAX; deepseek-moe-16b one train step on
                LM_TP_TRAIN, its loss within LM_TP_LOSS_RTOL.
 17. gnn      — DimeNet at its published config (6 blocks, hidden 128,
                f32) trained GNN_STEPS steps of adamw(1e-3) on each of
                GNN_CELLS (full_graph_sm, minibatch_lg through the fan-out
                sampler, molecule at 128 graphs), each batch built on the
                host from --seed (its real and padded counts and host
                seconds printed); ogb_products is skipped with its reason
                (GNN_SKIPPED). Per cell: losses, step ms (median, min and
                max after the first), peak bytes, the step's f32 bound and
                share over the real rows first, then over the padded rows,
                the bag kernels' and bag_grouping's launches per step;
                finite losses, every parameter moved, each step's
                launches equal to gnn_step_launches' (20
                backward and 4 groupings, 22 and 6 on molecule) and no
                other kernel (asserted). Then the first step twice at
                minibatch_lg, bit-equal; the card against the CPU at
                molecule and full_graph_sm (the gradients' errors to a
                float64 run on each run's own bases and ReLU branches
                within GNN_F64_RATIO of the CPU's, worst and median leaf);
                segment_sum
                and the one-id bag at minibatch_lg's shapes (D = 128) and
                molecule's graph readout (D = 1), and segment_sum on a
                10,000-member hub (GNN_HUB), bit-equal to their plain
                versions, timed beside index_add_ / F.embedding_bag (one
                call and device); at each segment_sum shape the grouping
                alone (exact against its plain version, beside
                torch.sort(stable=True)), the sum over a prepared plan and
                the two together;
                one profiled step; the dimenet launchers (gnn_cli).
 18. dryrun   — the dry run (repro_torch.launch.dryrun): the meta sweep
                (--all --include-ann --mesh single multi: every cell on
                the (16, 16) and (2, 16, 16) meshes of meta devices, run
                in DRYRUN_JOBS worker processes in the background from
                just after the build, on the host's cores) is waited for
                (DRYRUN_TIMEOUT) and its seconds printed; err=0, its ok
                and skipped cells exactly iter_cells(include_ann=True) x 2
                meshes, skipped only where the config gives a reason
                (long_500k on the full-attention LMs), with that reason;
                every record, meta and card, named
                {arch}__{shape}__{mesh}[__cuda]__torch.json and naming
                "package": "repro_torch" (asserted); one "dryrun_train"
                line per train cell and mesh (link_bytes_per_device, the
                all-reduce count: the merges and the gradients'
                all-reduce; bytes_per_device; the partition).
                Then every cell once more on this card (run_cell_cuda: a
                1 x 1 mesh, weights and inputs from --seed) where its
                1 x 1 meta run fits 90% of the card; one line per cell
                (measured ms beside the roofline's, the share, the peak
                beside the meta estimate); each card run's counted FLOPs
                and bytes equal to its meta run's, the meta peak at most
                10% under the card's, and beam_hops, l2topk,
                embedding_bag, its backward and bag_grouping each
                launched in the phase ("launches_dryrun") (asserted).
 15. the kernels line: launches on the main path (fit + serve for the f32
                kernels and l2topk, quantize + serve for the LUT kernels,
                recsys + recsys_ann for embedding_bag, the two-tower
                training steps of 14a for embedding_bag_backward and
                bag_grouping), errors,
                times and bounds; every kernel must have launched.
                "launches_train" is each kernel's count over those steps,
                "launches_recsys" over phases 11-12, which must be > 0
                for every kernel of the two-tower path (RECSYS_KERNELS).
                A LUT kernel's entry holds its M = 300 times with its
                launches over both backends, and under "by_m" each M's
                times and launches (pq runs M = 300, int8 M = 600); the
                l2topk entry holds its AntiHub-shape times, and under
                "by_shape" each shape's, and its launches per variant over
                the main path, quantize (PQ's codec), tune and the two-tower
                phases; "launches_tune" is each kernel's count over the
                tune phase. The fit must launch the tc and tile variants,
                PQ's codec the small one. beam_hops_lut gives its launches
                per variant per M ("launches_by_variant") and in the kernels
                phase, where both variants must have launched; topk_merge
                its launches per variant over fit + serve, tune and the
                two-tower phases (and under "by_shape" each shape's), and
                lut_dist per M over quantize + serve; alpha_scan its
                launches per variant over the main fit
                ("launches_by_variant") and each fit
                ("launches_by_variant_fits"), and under "variants" each
                variant's times; "launches_fit_auto"
                is each kernel's count over phase 8b (topk_merge's also by
                mode, l2topk's by variant), "launches_factory" over phase
                10c (every fit and one search per family), "launches_sharded"
                and "launches_streamed" over phases 10d and 10e,
                "launches_sharded_toggles" over 10f, "launches_gnn" over
                the gnn cells' steps (> 0 for both bag kernels and
                bag_grouping, whose "by_shape_gnn" holds phase 17's kernel
                checks);
                gather_dist's and beam_hops' "by_mode" give each toggle
                mode's times and bound (phase 3) and launches (10f). The
                one-hop entries (beam_hop, beam_hop_lut; "on_main_path":
                false) must launch no time on the main path: the fused
                search runs beam_hops.

Any failed check exits non-zero. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

# Data-sheet peaks (NVIDIA H100 SXM, dense, without sparsity) of the one
# card this script's bounds were written for, under the name torch reports:
# device-memory bytes/s, float32 operations/s outside the tensor cores,
# TF32 and bf16 operations/s on them. Set by load_peaks from the port's
# analysis/roofline.py, their one source.
PEAK_CARD = PEAK_BW = PEAK_F32 = PEAK_TF32 = PEAK_BF16 = None

TOPK_SHAPE = dict(b=2048, m=96, k=64)      # NSG pool assembly
# topk_merge at the next slices' shapes (ann-laion: degree 32, chunks and
# blocks of 2048 rows): the device finish's union (pool mode, R + rev_cap =
# 32 + 64 kept whole) and NN-Descent's merge under the reference's
# nn_descent defaults at k = 32 (kk = 32 table entries + mc - 1 = 20 direct
# + u_slots = 64 proposal candidates); then the rest of the default fit's
# widths (fit_auto): the random-projection joins (bsize 32) of the
# structural table (kk 32) and of the AntiHub one (kk 20), the subset seed
# (10 raw neighbours), the AntiHub table's rounds (kk 20 + 20 direct +
# u_slots 40) and the table pools (pool mode: 32 forward + 32 reverse +
# 32 x 4 hops, kept 64)
TOPK_SHAPES = {"pool_assembly": dict(TOPK_SHAPE, merge=False),
               "finish_union": dict(b=2048, m=96, k=96, merge=False),
               "nn_descent_merge": dict(b=2048, m=116, k=32, merge=True),
               "rp_join": dict(b=2048, m=64, k=32, merge=True),
               "rp_join_antihub": dict(b=2048, m=52, k=20, merge=True),
               "subset_seed": dict(b=2048, m=42, k=32, merge=True),
               "nn_descent_merge_antihub": dict(b=2048, m=80, k=20,
                                                merge=True),
               "table_pools": dict(b=2048, m=192, k=64, merge=False)}
HOP_SHAPE = dict(q=1024, ef=64, r=32)      # one serving hop
LUT_MS = (300, 600)                        # pq (default_pq_m(600)), int8
PER_QUERY_M = 2048                         # a LUT loop route sends per_query
LUT_C = 256
SERVE_RUNS = 7                             # timed searches (median)
REF_QUERIES = 256                          # searched again on the CPU
TUNE_TRIALS = 8                            # the tune phase's study
TUNE_CLI_ARGS = ["--n", "20000", "--dim", "768", "--queries", "256",
                 "--trials", "6", "--mode", "multi", "--max-degree", "32"]
TUNE_CLI_TIMEOUT = 600
P99_BATCHES = 100                          # timed serve_p99 batches
BULK_BATCHES = 3                           # timed serve_bulk batches
RETRIEVAL_REQUESTS = 5                     # timed 1 x 1M retrievals
RECSYS_ANN_ITEMS = 300_000                 # 2M items cut to 300k
RECSYS_ANN_QUERIES = 1024
RECSYS_ANN_PARAMS = dict(antihub_keep=1.0, ep_clusters=16, ef_search=64,
                         graph_degree=16, build_knn_k=16,
                         build_candidates=48, knn_backend="exact",
                         finish_backend="host")
RECSYS_CLI_TIMEOUT = 300
# floors of the default-backend fit (fit_auto), pinned from its measured
# values on an NVIDIA H100 80GB HBM3 (--seed 0: recall@10 0.92256 of its
# 1024 queries, the NN-Descent table's recall against the exact 32-NN
# 0.50039; the same on every run), each about one point below
FIT_AUTO_RECALL_FLOOR = 0.91
FIT_AUTO_TABLE_RECALL_FLOOR = 0.49
# The baseline at --seed 0 on an NVIDIA H100 80GB HBM3, measured while the
# α-scan still stepped its candidate positions from the host: recall@10 of
# the exact/host fit and of fit_auto, fit_auto's kNN-table recall (all to 5
# places), and fit_auto's gather_dist launches over the fit and its 8
# searches, of which
# the per-position loop took one per candidate position of every chunk
# (prune L = 64, the interconnect's re-prune L = 96). The kernel gives the
# same graph, so the recalls must not move, and the loop's launches must go.
BASELINE_SEED0 = {"fit": 0.97822, "fit_auto": 0.92256,
                  "knn_table": 0.50039, "fit_auto_gather_dist": 21_403}
SCAN_CHUNK = 2048                          # rows per α-scan launch
SCAN_LOOP_POSITIONS = 64 + 96              # the loop's steps per chunk
# the α-scan's path shapes, by the recorder's key (L, per-row alpha): the
# prune stage (pools of 64), the interconnect's re-prune (forward 32 +
# reverse 64) and a reprune_family pass (the 32-wide adjacency, one alpha
# per row over the grid's 9 alphas)
SCAN_SHAPES = {"prune": (64, False), "interconnect": (96, False),
               "reprune_family": (32, True)}
# the compacted search's settings: (compact_every, patience)
COMPACT_SETTINGS = ((16, None), (8, 8))
# the kernels phases 11-12 run: the bag in the towers, the f32 graph kernels
# in recsys_ann's fit and search
RECSYS_KERNELS = ("embedding_bag", "gather_dist", "beam_hops", "topk_merge",
                  "l2topk", "alpha_scan")
# the one-hop entries of beam_hop.cu: checked and timed in the kernels
# phase, but no longer on the main path (a fused search on the card runs
# its whole loop in beam_hops / beam_hops_lut)
OFF_PATH = ("beam_hop", "beam_hop_lut")
# the k of the wide l2topk call (FlatIndex.search over the raw base)
FLAT_WIDE_K = 256
# the factory phase: the paper's Fig. 1 specs and SearchParams
# (benchmarks/fig1_index_comparison.py), plus IVF-PQ, built through
# build_index on the ann-laion data; the kernel each family's search must
# launch; the graph families' recall floor (the serve phase's)
FACTORY_SPECS = (("Flat", {}), ("NSG24,EP1", {"ef_search": 64}),
                 ("IVF128,Flat", {"nprobe": 8}), ("PQ16", {}),
                 ("IVFPQ128x16", {"nprobe": 8}))
HNSW_SPEC, HNSW_PARAMS = "HNSW16,Flat", {"ef_search": 64}
FAMILY_KERNEL = {"Flat": "l2topk", "NSG": "beam_hops", "IVF": "gather_dist",
                 "PQ": "lut_dist", "IVFPQ": "lut_dist", "HNSW": "beam_hops"}
# each spec's recall@10 floor: Flat's exactness, else about one point
# under its reading on an NVIDIA H100 80GB HBM3 at --seed 0 (the same in
# every run: NSG24,EP1 0.93555, IVF128,Flat 0.98945, PQ16 0.01934,
# IVFPQ128x16 0.14063, HNSW16,Flat at 5k 0.99756); the graph families
# never below the serve phase's 0.80
FACTORY_RECALL_FLOOR = {"Flat": 0.999, "NSG24,EP1": 0.92, "IVF128,Flat": 0.98,
                        "PQ16": 0.015, "IVFPQ128x16": 0.13,
                        "HNSW16,Flat": 0.99}
# the kernels whose first call in a family's search is held against its
# plain version on the same operands (factory_kernel_check)
FAMILY_CHECKED = {"IVF": ("l2topk", "gather_dist"), "PQ": ("lut_dist",),
                  "IVFPQ": ("l2topk", "lut_dist")}
# HNSW's build is the reference's sequential host insert; it runs on the
# first HNSW_CUT rows, fixed so that runs compare. A 10k build took 83.7 s
# on the card's host in one run and the 5k build 30.0-44.3 s in others, so
# 10k would outgrow a 90 s share of the phase on the slower hosts
HNSW_CUT = 5_000
# the PQ families' ADC check: with every list probed, the ADC top-10 must
# be (nearly) the exact top-10 over the index's own reconstructions; the
# two sums round differently, so near-ties may swap
ADC_CHECK_FLOOR = 0.95
# the stepped-snapshot check's small index
SNAPSHOT_SMALL = ("IVF16", 4_000)
SERVE_CLI_TIMEOUT = 300
# the ANN launchers, each a subprocess, and each one's recall@10 floor:
# about one point under its reading on an NVIDIA H100 80GB HBM3 (the
# default spec 0.9141, IVF64,Flat 0.9594, the same in every run), above the
# reference's floors for the specs (tests/test_index_api.py: PCA specs
# 0.50, IVF 0.85)
SERVE_CLI_RUNS = (
    ("default", ["--arch", "ann-laion"], 0.90),
    ("ivf_snapshot", ["--arch", "ann-laion", "--spec", "IVF64,Flat",
                      "--buckets", "off", "--snapshot", "{snap}"], 0.95),
    ("ivf_restore", ["--arch", "ann-laion", "--buckets", "off",
                     "--restore", "{snap}"], 0.95))
TUNE_SPEC_ARGS = ["--spec", "IVF64,Flat", "--n", "2000", "--dim", "32",
                  "--trials", "6", "--mode", "single"]
# the sharded phases (ROADMAP item 9): 4 shards, the mesh naming cuda:0
# four times; the reprune every tier derives; the row block of
# derive_local's alpha_scan launches (build/shardlocal.py's _BLK)
SHARDS = 4
REPRUNE = (1.2, 24)
SHARDLOCAL_BLOCK = 1024
# PQ16 row-sharded on the first PQ_CUT rows (its per-shard codebook fit
# is the slow part), so that the LUT kernel runs on the sharded path
PQ_CUT = 40_000
# the streamed phase: 4 shards of the config's own 300k rows
STREAMED_N = 1_200_000
STREAMED_QUERIES = 1024
# recall@10 floors of the sharded phases, about one point under their
# first readings on an NVIDIA H100 80GB HBM3 at --seed 0 (PERF.md, run A:
# the two tiers 0.96113, after reprune(1.2, 24) 0.81807, sharded PQ16 at
# 40k 0.04590, the streamed 1.2M 0.92979)
SHARDED_RECALL_FLOOR = 0.95
SHARDED_REPRUNE_FLOOR = 0.80
PQ_SHARDED_FLOOR = 0.035
STREAMED_RECALL_FLOOR = 0.91
# the kernels the sharded path must launch (lut_dist through sharded PQ16)
SHARDED_KERNELS = ("beam_hops", "gather_dist", "l2topk", "alpha_scan",
                   "topk_merge", "lut_dist")
# the ANN toggles' modes of gather_dist and beam_hops (bf16 rows, the
# prenorm distance, both), and each mode's sharded recall@10 floor, a point
# under its first reading (PERF.md, PR 24: 0.95723, 0.96113, 0.94863), and
# the streamed 1.2M's under bf16 (0.92588)
MODE_NAMES = ("bf16", "prenorm", "bf16+prenorm")
TOGGLE_RECALL_FLOOR = {"bf16": 0.947, "prenorm": 0.951, "bf16+prenorm": 0.938}
STREAMED_BF16_RECALL_FLOOR = 0.915
# the three recsys models' phase: DLRM's tables capped at 2^24 rows each
# (87,950,072 rows x 128 f32 = 45.0 GB; all 187,767,399 would take
# 96.1 GB, over the card's 80 GB), its lookup row-sharded over a mesh
# naming cuda:0 four times; the card's scores against the CPU's
DLRM_ROW_CAP = 1 << 24
RECSYS_MODELS = ("sasrec", "din", "dlrm-mlperf")
RECSYS_CPU_ROWS = 64
RECSYS_CPU_TOL = dict(rtol=1e-4, atol=1e-5)
# the training phases: steps per model at RECSYS_SHAPES["train_batch"]
# (65,536), DLRM's tables capped at 2^23 rows each (46,007,032 rows x 128
# f32 = 23.6 GB: its table and its dense gradient fit one card, the
# serving cap's 45.0 GB and its gradient would not); the Trainer's resume
# on SASRec at full config (TRAINER_STEPS: the whole run and where it is
# interrupted, at TRAINER_BATCH) and the train launcher's runs
TRAIN_STEPS = 3
TRAIN_MODELS = ("sasrec", "din", "dlrm-mlperf")
DLRM_TRAIN_ROW_CAP = 1 << 23
TRAINER_STEPS = (6, 4)
TRAINER_BATCH = 4096
TRAINER_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_CLI_RUNS = (
    ("two-tower-retrieval", ["--steps", "4"]),
    ("sasrec", ["--full-config", "--steps", "4", "--batch", "4096"]))
TRAIN_CLI_TIMEOUT = 300
# the launchers' --shards runs and each one's recall@10 floor, about a
# point under its reading (PERF.md, run A): the best trial of tune's 4
# startup trials 0.9977; tune --spec's 12 trials reach 1.0, but past the
# 5 startup trials TPE follows the measured QPS, so the floor sits under
# its startup trial 04's 0.9516; serve 0.9141
SHARDED_CLI_RUNS = (
    ("tune_streamed", "repro_torch.launch.tune",
     ["--shards", "4", "--n", "20000", "--dim", "768", "--trials", "4"],
     0.98, {}),
    ("tune_streamed_bf16", "repro_torch.launch.tune",
     ["--shards", "4", "--n", "20000", "--dim", "768", "--trials", "4"],
     0.98, {"REPRO_ANN_BF16": "1"}),
    ("tune_spec", "repro_torch.launch.tune",
     ["--spec", "NSG16", "--shards", "4"], 0.94, {}),
    ("serve", "repro_torch.launch.serve",
     ["--arch", "ann-laion", "--shards", "4", "--on-shard-error", "skip"],
     0.90, {}))
# the dense LM phases (ROADMAP Queue 1 item 10.6a): the three configs at
# full width in bf16 from --seed. LM_CUTS gives the (batch, tokens) each
# LM_SHAPES cell runs at: prefill_32k's global batch 32 and decode_32k's 128
# do not fit one card beside the weights, and the reference's float32
# attention over every KV block takes ~9 s per 32k qwen2-1.5b prompt (~30
# s mistral-nemo-12b, ~110 s qwen3-32b), so the larger two prefill 8,192
# tokens; qwen3-32b's 32k prompt would not fit at all (65.5 GB of weights,
# its 8.6 GB cache and an 8.6 GB score block). A decode cell's cache is
# filled with random values instead of a 32k prefill per row: a step's
# work does not depend on them. long_500k is skipped by skip_reason.
#
# The MoE / MLA configs (item 10.6b): deepseek-moe-16b at full size (32.75
# GB); deepseek-v2-236b cut in depth to LM_LAYERS (the whole is 471.5 GB:
# no card holds it), width, experts, heads and vocabulary as published.
# Both prefill 8,192 tokens as the 12b / 32b; deepseek-moe-16b decodes 4
# rows at 32k (its MHA cache is 7.52 GB a row: 30.06 GB), deepseek-v2-236b
# 32 (its latent cache 1,152 B per token and layer: 9.66 GB)
LM_ARCHS = ("qwen2-1.5b", "mistral-nemo-12b", "qwen3-32b",
            "deepseek-moe-16b", "deepseek-v2-236b")
LM_LAYERS = {"deepseek-v2-236b": 8}
LM_CUTS = {"qwen2-1.5b": {"prefill_32k": (1, 32768),
                          "decode_32k": (64, 32768)},
           "mistral-nemo-12b": {"prefill_32k": (1, 8192),
                                "decode_32k": (8, 32768)},
           "qwen3-32b": {"prefill_32k": (1, 8192),
                         "decode_32k": (1, 32768)},
           "deepseek-moe-16b": {"prefill_32k": (1, 8192),
                                "decode_32k": (4, 32768)},
           "deepseek-v2-236b": {"prefill_32k": (1, 8192),
                                "decode_32k": (32, 32768)}}
# check 1 of an MoE config runs at capacity factor E / k, where a group's
# every pair fits (cap = group size + 1): capacity drops depend on which
# tokens share a group, so forward over the sequence and prefill + decode
# would route apart at the published 1.25 by design (lm_check_config)
LM_DECODE_STEPS = 8                         # timed greedy steps per cell
# check 1: prefill LM_CHECK[0] tokens, decode LM_CHECK[1] greedily, against
# forward over the whole sequence, in bf16: the logits' relative RMS
# difference at most LM_BF16_REL and the largest at most LM_BF16_MAX of the
# largest |logit| (the two paths multiply at other shapes, so cuBLAS sums
# in other orders and bf16 rounds at other places). Pinned from the first
# run on an NVIDIA H100 80GB HBM3 (relative RMS 0.0072 / 0.0161 / 0.0192,
# largest 0.047 / 0.086 / 0.105 of 3.6 / 5.8 / 4.7 for the three configs),
# each about 2.6 times the worst reading. An MoE config's greedy run can
# route a near-tie token to another expert on bf16 rounding alone: the
# phase counts those flips and their positions, then runs prefill + decode
# again with each MoE call routed to the forward's ids
# (moe.forced_routing), and holds that run to the same limits
LM_CHECK = (64, 8)
LM_BF16_REL, LM_BF16_MAX = 0.05, 0.06
# the prefill cells profiled (one more call under torch.profiler: device
# busy share and top kernels); every decode cell profiles one more step
LM_PROFILE_PREFILL = ("mistral-nemo-12b",)
# check 2: attention above CHUNK_THRESHOLD (chunked_sdpa) against sdpa in
# float32 at qwen2-1.5b's heads; check 3: a 2-layer qwen2-1.5b at full
# width and vocabulary in float32, the card against the CPU
LM_ATTN_CHECK = dict(b=1, s=4096, h=12, kv=2, hd=128)
LM_ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
LM_CPU_TOKENS = (2, 16)
LM_CPU_TOL = dict(rtol=1e-4, atol=1e-5)
# check 4's MoE layer on integer-valued inputs: B x S tokens through
# deepseek-moe-16b's layer (2 groups of 1,024, the published capacity), x a
# shared integer row in [-4, 4] plus integer noise in [-1, 1] (alike
# tokens crowd the same experts, so pairs drop) and the router rounded to
# multiples of 1/64, so every logit is exact on either device; the layer's
# output to rtol 1e-4 and atol LM_MOE_LAYER_ATOL of its largest magnitude
# (its expert terms cancel); check 5: the absorbed MLA decode against the
# rebuilding one at deepseek-v2's head shapes in f32, B rows over S cached
# positions
LM_MOE_INT_TOKENS = (1, 2048)
LM_MOE_LAYER_ATOL = 1e-5
LM_MLA_CHECK = dict(b=2, s=4096)
LM_MLA_TOL = dict(rtol=1e-4, atol=1e-4)
# lm_train: qwen2-1.5b at full width, train_4k (global batch 256 x 4,096)
# cut to 4 sequences in 2 microbatches, adamw(3e-4) as launch.train
# deepseek-moe-16b at full width cut to 4 of its 28 layers (1 dense + 3
# MoE: 2.27 B parameters, ~27 GB with gradients and AdamW's f32 moments)
LM_TRAINS = (dict(arch="qwen2-1.5b", layers=None, batch=4, seq=4096,
                  microbatches=2, steps=3, lr=3e-4),
             dict(arch="deepseek-moe-16b", layers=4, batch=4, seq=4096,
                  microbatches=2, steps=3, lr=3e-4))
# lm_tp: qwen2-1.5b tensor-parallel over meshes of cuda:0 repeated; the
# serve mesh (1 x 4) splits the 2 KV heads' cache on sequence, the train
# mesh (2 x 2) is two batch groups of two shards. Prefill 1 x 8,192; then
# 8 prompts of 8,192 - LM_TP_DECODE_STEPS tokens prefilled into an 8,192
# cache and LM_TP_DECODE_STEPS greedy steps (both sides fed the unsharded
# run's ids); one train step of 4 x 1,024. The sharded loss against the
# unsharded one: LM_TP_LOSS_RTOL
LM_TP_SERVE = (1, 4)
LM_TP_TRAIN = (2, 2)
LM_TP_PREFILL = (1, 8192)
LM_TP_DECODE = (8, 8192)
LM_TP_DECODE_STEPS = 16
LM_TP_BATCH = (4, 1024)
LM_TP_LOSS_RTOL = 1e-2
# lm_tp's MoE / MLA configs at full width, cut in depth (listed on an
# lm_tp_cut line first): deepseek-moe-16b to 4 of its 28 layers (1 dense +
# 3 MoE) with a train step of LM_TP_BATCH on LM_TP_TRAIN, deepseek-v2-236b
# to 3 of 60 (1 dense + 2 MoE, ~18 GB of weights) serving only. Prefill
# LM_TP_PREFILL on LM_TP_SERVE; then LM_TP_MOE_DECODE prompts of
# LM_TP_MOE_DECODE[1] - LM_TP_MOE_DECODE_STEPS = 4,096 tokens (whole
# dispatch groups of 1,024) and that many greedy steps. Both sides take the unsharded run's ids, and the sharded run is
# routed to the unsharded run's experts (moe.forced_routing): its dropped
# pairs must be the unsharded run's
LM_TP_MOE = (dict(arch="deepseek-moe-16b", layers=4, train=True),
             dict(arch="deepseek-v2-236b", layers=3, train=False))
LM_TP_MOE_DECODE = (4, 4104)
LM_TP_MOE_DECODE_STEPS = 8
LM_CLI_ARCHS = ("qwen2-1.5b", "deepseek-moe-16b", "deepseek-v2-236b")
LM_CLI_RUNS = tuple(
    run for arch in LM_CLI_ARCHS for run in (
        ("serve", "repro_torch.launch.serve", ["--arch", arch]),
        ("train", "repro_torch.launch.train",
         ["--arch", arch, "--steps", "2"])))
LM_CLI_TIMEOUT = 300

# 17. DimeNet (item 10.6c): its published config trained on the GNN_SHAPES
# cells one card holds; molecule scaled as the reference's
# launch/specs.py:205-209 scales it (the cell's graph times n_graphs)
GNN_CELLS = ("full_graph_sm", "minibatch_lg", "molecule")
GNN_SKIPPED = {"ogb_products": (
    "one (T, 128) f32 activation is 63.3 GB at 123,718,280 triplets and one "
    "(E, 128) 31.7 GB at 61,859,140 edges, so a block's forward alone is "
    "over one 80 GB card; the reference only lowers this cell, edge-sharded "
    "over a mesh (launch/specs.py:202-283): it waits for a multi-card mesh")}
GNN_STEPS = 10                    # the median and spread of steps 2-10
GNN_LR = 1e-3
GNN_KERNELS = ("embedding_bag", "embedding_bag_backward", "bag_grouping")
# a segment_sum whose ids put 10,000 of 40,000 rows on one segment (a hub:
# its run stays in one warp) into 3,000 segments at D = 128
GNN_HUB = dict(rows=40_000, hub=10_000, segments=3_000, d=128)
GNN_DETERMINISM_CELL = "minibatch_lg"
GNN_CPU_CELLS = ("molecule", "full_graph_sm")
# the card against the CPU on the same weights and batch. The loss: within
# GNN_CPU_LOSS_RTOL of the CPU's. The gradients: each device's float32 run
# is held to a float64 run of the same step on that run's own bases and
# ReLU branches (the MLPs' ReLUs start at zero biases and meet
# pre-activations within rounding of 0, so each device flips a few units'
# masks; the bases are inputs no gradient reaches), as a share of each
# leaf's largest magnitude. The published depth at random weights
# amplifies float32 rounding into 1e-6 to 2e-4 of a leaf's scale on either
# device, which leaf the most varying with the device and the seed (PERF.md
# §6). So every card leaf must lie within GNN_F64_RATIO times the CPU's
# worst leaf, and the card's median leaf within GNN_F64_RATIO times the
# CPU's: a 0.1% fault on one leaf fails the first, a 1e-4 shift of every
# leaf the second
GNN_CPU_LOSS_RTOL = 1e-5
GNN_F64_RATIO = 3.0
# the rows each array of a graph batch is indexed by (any other: nodes)
GNN_ROW_KIND = {"t_kj": "triplets", "t_ji": "triplets", "src": "edges",
                "dst": "edges", "edge_mask": "edges", "y_graph": "graphs"}
GNN_CLI_RUNS = (
    ("train", "repro_torch.launch.train", ["--arch", "dimenet", "--steps",
                                           "4"]),
    ("serve", "repro_torch.launch.serve", ["--arch", "dimenet"]))
GNN_CLI_TIMEOUT = 300

# the l2topk variant each shape must take (PERF.md names them)
L2TOPK_ROUTES = {"antihub": "tc", "knn": "tc", "ground_truth": "tc",
                 "kmeans": "tile", "medoid": "tile", "entry_select": "tile",
                 "pq": "small", "flat_wide": "wide"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def load_peaks() -> None:
    """The data-sheet peaks from ``repro_torch.analysis.roofline``."""
    global PEAK_CARD, PEAK_BW, PEAK_F32, PEAK_TF32, PEAK_BF16
    from repro_torch.analysis import roofline as R
    PEAK_CARD, PEAK_BW = R.CARD, R.HBM_BW
    PEAK_F32, PEAK_TF32 = R.PEAK_FLOPS_F32, R.PEAK_FLOPS_TF32
    PEAK_BF16 = R.PEAK_FLOPS_BF16


def peaks(name: str):
    if PEAK_CARD is None:
        load_peaks()
    if name != PEAK_CARD:
        raise RuntimeError(f"no data-sheet peaks for {name!r}; bounds are "
                           f"known for {PEAK_CARD!r} only")
    return PEAK_BW, PEAK_F32


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def zero_counts(wrappers: dict) -> None:
    """Every wrapper's launch count to 0, the per-variant counts too."""
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "by_variant"):
            w.by_variant = dict.fromkeys(w.by_variant, 0)
        if hasattr(w, "by_mode"):
            w.by_mode = {m: dict.fromkeys(c, 0) if isinstance(c, dict) else 0
                         for m, c in w.by_mode.items()}


def bound(bytes_moved: float, ops: float, name: str, ops_rate=None):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over ``ops_rate`` (default: f32 outside
    the tensor cores)."""
    bw, flops = peaks(name)
    t_bytes = bytes_moved / bw * 1e3
    t_ops = ops / (flops if ops_rate is None else ops_rate) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


class Cycle:
    """Round-robin over input sets, so repeated timings do not find the
    previous call's rows in the 50 MB L2 cache."""

    def __init__(self, items):
        self.items, self.i = items, 0

    def next(self):
        self.i = (self.i + 1) % len(self.items)
        return self.items[self.i]


def kernel_phase(torch, n: int, d: int, gpu: str, seed: int) -> dict:
    """Each kernel at the main path's shapes against its plain version."""
    from repro_torch.kernels.beam_hop import beam_hop_cuda, beam_hop_ref
    from repro_torch.kernels.gather_dist import gather_dist_cuda, \
        gather_dist_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 101)
    res = {}

    def ints(shape):
        return torch.randint(-8, 9, shape, generator=g, device=dev).float()

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev)

    def ids(shape, lo=-1):
        return torch.randint(lo, n, shape, generator=g, device=dev,
                             dtype=torch.int32)

    # -- gather_dist: the staged hop's (B, R) block over the projected base
    b, r = HOP_SHAPE["q"], HOP_SHAPE["r"]
    worst = 0.0
    for kind in ("int", "float"):
        db = ints((n, d)) if kind == "int" else randn((n, d))
        q = ints((b, d)) if kind == "int" else randn((b, d))
        idx = ids((b, r))
        got = gather_dist_cuda(q, db, idx)
        want = gather_dist_ref(q, db, idx)
        if kind == "int":
            if not torch.equal(got, want):
                raise AssertionError("gather_dist differs on integer data")
        else:
            fin = torch.isfinite(want)
            if not torch.equal(fin, torch.isfinite(got)):
                raise AssertionError("gather_dist: +inf pattern differs")
            err = (got[fin] - want[fin]).abs()
            if not bool((err <= 1e-5 + 1e-5 * want[fin].abs()).all()):
                raise AssertionError("gather_dist beyond rtol=atol=1e-5")
            worst = float(err.max())
    sets = Cycle([ids((b, r)) for _ in range(8)])
    ms = time_ms(lambda: gather_dist_cuda(q, db, sets.next()))
    dev_ms = queued_ms(torch, lambda: gather_dist_cuda(q, db, sets.next()))
    plain = time_ms(lambda: gather_dist_ref(q, db, sets.next()))
    uniq = sum(int(torch.unique(s[s >= 0]).numel()) for s in sets.items) / 8
    bmin, by = bound(uniq * d * 4 + b * d * 4 + b * r * 8, 3 * b * r * d,
                     gpu)
    res["gather_dist"] = dict(
        route="cuda", source="src/repro_torch/csrc/gather_dist.cu",
        replaces="src/repro/kernels/gather_dist/gather_dist.py:34",
        max_abs_err=worst, ms=ms, device_ms=dev_ms, plain_ms=plain,
        bound_ms=bmin, bound_by=by, share_of_bound=bmin / dev_ms,
        library_ms=None, shape=dict(b=b, r=r, d=d, n=n))

    # -- beam_hop: one serving hop of Q queries
    nq, ef = HOP_SHAPE["q"], HOP_SHAPE["ef"]

    def hop_inputs(kind):
        db = ints((n, d)) if kind == "int" else randn((n, d))
        q = ints((nq, d)) if kind == "int" else randn((nq, d))
        nbrs = ids((n, r))
        pool_i = ids((nq, ef))
        pool_d = torch.where(pool_i >= 0,
                             torch.randint(0, 2000, (nq, ef), generator=g,
                                           device=dev).float(),
                             float("inf")).sort(1).values
        pool_v = torch.rand((nq, ef), generator=g, device=dev) < 0.5
        # duplicates with the pool: some graph rows point at pool members
        sel = ids((nq,))
        return sel, nbrs, pool_i, pool_d, pool_v, q, db

    worst = 0.0
    for kind in ("int", "float"):
        args = hop_inputs(kind)
        sel, nbrs, pool_i = args[0], args[1], args[2]
        live = sel >= 0
        nbrs[sel[live].long(), :8] = pool_i[live, :8]
        got = beam_hop_cuda(*args)
        want = beam_hop_ref(*args)
        if kind == "int":
            for a_, b_ in zip(got, want):
                if not torch.equal(a_, b_):
                    raise AssertionError("beam_hop differs on integer data")
        else:
            fin = torch.isfinite(want[1])
            if not torch.equal(fin, torch.isfinite(got[1])):
                raise AssertionError("beam_hop: +inf pattern differs")
            err = (got[1][fin] - want[1][fin]).abs()
            if not bool((err <= 1e-5 + 1e-5 * want[1][fin].abs()).all()):
                raise AssertionError("beam_hop dists beyond rtol=atol=1e-5")
            # a near-tie may swap two entries of a row; where the ids agree,
            # the visited flags must agree too
            same = (got[0] == want[0]).all(1)
            if float(same.float().mean()) < 0.99 or not torch.equal(
                    got[3], want[3]):
                raise AssertionError("beam_hop ids/stats differ (float)")
            if not torch.equal(got[2][same], want[2][same]):
                raise AssertionError("beam_hop visited flags differ (float)")
            worst = float(err.max())
    sels = Cycle([ids((nq,)) for _ in range(8)])
    sel, nbrs, pool_i, pool_d, pool_v, q, db = args
    ms = time_ms(lambda: beam_hop_cuda(sels.next(), nbrs, pool_i, pool_d,
                                       pool_v, q, db))
    dev_ms = queued_ms(torch, lambda: beam_hop_cuda(
        sels.next(), nbrs, pool_i, pool_d, pool_v, q, db))
    plain = time_ms(lambda: beam_hop_ref(sels.next(), nbrs, pool_i, pool_d,
                                         pool_v, q, db))
    gathered = 0.0
    for s in sels.items:
        rows = nbrs[s.clamp_min(0).long()][s >= 0]
        gathered += int(torch.unique(rows[rows >= 0]).numel()) / 8
    bmin, by = bound(gathered * d * 4 + nq * d * 4 + nq * r * 4
                     + 2 * nq * ef * 9 + nq * 12, 3 * nq * r * d, gpu)
    res["beam_hop"] = dict(
        route="cuda", source="src/repro_torch/csrc/beam_hop.cu",
        replaces="src/repro/kernels/beam_hop/beam_hop.py:117",
        max_abs_err=worst, ms=ms, device_ms=dev_ms, plain_ms=plain,
        bound_ms=bmin, bound_by=by, share_of_bound=bmin / dev_ms,
        library_ms=None, shape=dict(q=nq, ef=ef, r=r, d=d, n=n))

    res["topk_merge"] = topk_kernel_phase(torch, g, gpu)
    res.update(lut_kernel_phase(torch, n, g, gpu))
    return res


def topk_inputs(torch, g, shape: dict, kind: str):
    """(ids, dists, fresh) rows of ``shape``: ids repeat within a row and
    carry one distance per id per row (as a pool's copies of a node do),
    integer-valued or float; fresh random (merge mode) or None."""
    dev = torch.device("cuda")
    b, m = shape["b"], shape["m"]
    idx = torch.randint(-1, 3 * m, (b, m), generator=g, device=dev,
                        dtype=torch.int32)
    table = (torch.randint(0, 50, (b, 3 * m), generator=g,
                           device=dev).float() if kind == "int"
             else torch.rand((b, 3 * m), generator=g, device=dev))
    ds = torch.where(idx >= 0, table.gather(1, idx.clamp_min(0).long()),
                     float("inf"))
    fresh = (torch.rand((b, m), generator=g, device=dev) < 0.5
             if shape["merge"] else None)
    return idx, ds, fresh


def topk_kernel_phase(torch, g, gpu: str) -> dict:
    """topk_merge at TOPK_SHAPES, each variant equal to its plain version
    on integer and float rows; device_ms of each (queued_ms) with its bound
    and share, the route's variant at the top of each shape."""
    from repro_torch.kernels.topk_merge import topk_merge_cuda, \
        topk_merge_ref, topk_pool_ref
    from repro_torch.kernels.topk_merge.topk_merge import VARIANTS, route

    def run(args, k, merge, variant):
        return topk_merge_cuda(*args, k, merge=merge, variant=variant)

    def plain(args, k, merge):
        ids, ds, fresh = args
        if not merge:
            return (*topk_pool_ref(ids, ds, k), None)
        return topk_merge_ref(ids, ds, fresh, ids[:, :0], ds[:, :0], k)

    by_shape, worst = {}, 0.0
    for name, shape in TOPK_SHAPES.items():
        b, m, k, merge = shape["b"], shape["m"], shape["k"], shape["merge"]
        for kind in ("int", "float"):
            args = topk_inputs(torch, g, shape, kind)
            want = plain(args, k, merge)
            for v in VARIANTS:
                got = run(args, k, merge, v)
                if not all(w_ is None or torch.equal(a_, w_)
                           for a_, w_ in zip(got, want)):
                    raise AssertionError(f"topk_merge ({name}, {v}) differs "
                                         f"from its plain version ({kind} "
                                         f"data)")
                fin = torch.isfinite(want[1])
                if bool(fin.any()):
                    worst = max(worst, float(
                        (got[1][fin] - want[1][fin]).abs().max()))
        sets = Cycle([topk_inputs(torch, g, shape, "float")
                      for _ in range(8)])
        p = 1 << max(5, (m - 1).bit_length())
        stages = p.bit_length() - 1
        compares = b * 2 * (p // 2) * stages * (stages + 1) // 2
        per = 9 if merge else 8
        bmin, by = bound(b * m * per + b * k * per, compares, gpu)
        variants = {}
        for v in VARIANTS:
            dev_ms = queued_ms(torch, lambda: run(sets.next(), k, merge, v))
            variants[v] = dict(device_ms=dev_ms,
                               share_of_bound=bmin / dev_ms)
        chosen = route(m)
        by_shape[name] = dict(
            variant=chosen,
            ms=time_ms(lambda: run(sets.next(), k, merge, chosen)),
            device_ms=variants[chosen]["device_ms"],
            plain_ms=time_ms(lambda: plain(sets.next(), k, merge)),
            bound_ms=bmin, bound_by=by,
            share_of_bound=variants[chosen]["share_of_bound"],
            variants=variants, shape=dict(shape))
        del sets
    head = by_shape["pool_assembly"]
    return dict(route="cuda", source="src/repro_torch/csrc/topk_merge.cu",
                replaces="src/repro/kernels/topk_merge/topk_merge.py:86",
                max_abs_err=worst,
                **{k_: v for k_, v in head.items() if k_ != "shape"},
                library_ms=None, shape=head["shape"], by_shape=by_shape)


def lut_bytes(torch, codes, ids, m):
    """Bytes a LUT scoring of (Q, R) ``ids`` must move: each distinct LUT
    entry looked up (4 B) and each distinct code row (M B), read once."""
    q = ids.shape[0]
    valid = ids >= 0
    rows = codes[ids.clamp_min(0).long()].long()                 # (Q, R, M)
    key = ((torch.arange(q, device=ids.device)[:, None, None] * m
            + torch.arange(m, device=ids.device)) * LUT_C + rows)
    entries = int(torch.unique(key[valid]).numel())
    code_rows = int(torch.unique(ids[valid]).numel())
    return entries * 4 + code_rows * m


def lut_sector_bytes(torch, codes, ids, m):
    """The 32-byte sectors such a scoring touches: each distinct sector of
    the LUT that holds a looked-up entry (8 entries per sector) and the
    sectors of each distinct code row."""
    q = ids.shape[0]
    valid = ids >= 0
    rows = codes[ids.clamp_min(0).long()].long()
    key = ((torch.arange(q, device=ids.device)[:, None, None] * m
            + torch.arange(m, device=ids.device)) * LUT_C + rows)
    sectors = int(torch.unique(key[valid] // 8).numel())
    code_rows = int(torch.unique(ids[valid]).numel())
    return sectors * 32 + code_rows * -(-m // 32) * 32


def lut_kernel_phase(torch, n: int, g, gpu: str) -> dict:
    """lut_dist and beam_hop's LUT mode at the quantized path's shapes
    (M = 300 for pq, 600 for int8), each bit-equal to its plain version.
    lut_dist at R = 1 (the pool seed, its call on the main path) and at
    R = 32 (the staged hop, under "r32"), each with device_ms (queued_ms)
    and torch's embedding_bag over the same lookups. The kernels line
    carries the pq (M = 300) numbers; both are here."""
    from repro_torch.kernels.beam_hop import beam_hop_lut_cuda, beam_hop_ref
    from repro_torch.kernels.lut_dist import lut_dist_cuda, lut_dist_ref
    from repro_torch.kernels.lut_dist.lut_dist import VARIANTS, route

    dev = torch.device("cuda")
    nq, ef, r = HOP_SHAPE["q"], HOP_SHAPE["ef"], HOP_SHAPE["r"]
    out = {"lut_dist": {}, "beam_hop_lut": {}}
    worst = {"lut_dist": 0.0, "beam_hop_lut": 0.0}

    def err(got, want):
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(got)) or not bool(fin.any()):
            return math.inf
        return float((got[fin] - want[fin]).abs().max())

    def ids(shape, lo=-1):
        return torch.randint(lo, n, shape, generator=g, device=dev,
                             dtype=torch.int32)

    for m in LUT_MS:
        codes = torch.randint(0, LUT_C, (n, m), generator=g, device=dev,
                              dtype=torch.uint8)
        luts = {"int": torch.randint(0, 9, (nq, m, LUT_C), generator=g,
                                     device=dev).float(),
                "float": torch.rand((nq, m, LUT_C), generator=g,
                                    device=dev) * 10}
        # -- lut_dist: the pool seed's (Q, 1) entry block (its one call on
        # the main path), then the staged hop's (Q, R) block
        by_r = {}
        for rr, lo in ((1, 0), (r, -1)):
            for kind, lut in luts.items():
                idx = ids((nq, rr), lo)
                want = lut_dist_ref(lut, codes, idx)
                for v in VARIANTS:
                    got = lut_dist_cuda(lut, codes, idx, variant=v)
                    worst["lut_dist"] = max(worst["lut_dist"],
                                            err(got, want))
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"lut_dist (M={m}, R={rr}, {v}) differs from "
                            f"its plain version ({kind} data)")
            sets = Cycle([ids((nq, rr), lo) for _ in range(8)])
            call = lambda: lut_dist_cuda(lut, codes, sets.next())
            ms = time_ms(call)
            dev_ms = queued_ms(torch, call)
            variants = {v: queued_ms(torch, lambda: lut_dist_cuda(
                lut, codes, sets.next(), variant=v)) for v in VARIANTS}
            plain = time_ms(lambda: lut_dist_ref(lut, codes, sets.next()))
            # one PyTorch call of the same sum (order aside): embedding_bag
            # over flat LUT indices, built outside the timing
            flat_of = lambda s_: (
                (torch.arange(nq, device=dev)[:, None, None] * m
                 + torch.arange(m, device=dev)) * LUT_C
                + codes[s_.clamp_min(0).long()].long()).view(-1, m)
            flats = Cycle([flat_of(s_) for s_ in sets.items])
            table = lut.view(-1, 1)
            library_call = lambda: torch.nn.functional.embedding_bag(
                flats.next(), table, mode="sum")
            library = time_ms(library_call)
            library_dev = queued_ms(torch, library_call)
            del flats
            moved = sum(lut_bytes(torch, codes, s_, m)
                        for s_ in sets.items) / 8
            sectors = sum(lut_sector_bytes(torch, codes, s_, m)
                          for s_ in sets.items) / 8
            bmin, by = bound(moved + nq * rr * 8, nq * rr * m, gpu)
            by_r[rr] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                            bound_ms=bmin, bound_by=by,
                            share_of_bound=bmin / dev_ms,
                            variant=route(nq * rr),
                            variants={v: dict(device_ms=t_,
                                              share_of_bound=bmin / t_)
                                      for v, t_ in variants.items()},
                            sector_bytes=sectors,
                            sector_ms=sectors / PEAK_BW * 1e3,
                            library_ms=library,
                            library_device_ms=library_dev,
                            shape=dict(q=nq, r=rr, m=m, c=LUT_C, n=n))
        out["lut_dist"][m] = dict(by_r[1], **{f"r{r}": {
            k_: v for k_, v in by_r[r].items() if k_ != "shape"}})

        # -- beam_hop, LUT mode: one serving hop of Q queries
        nbrs = ids((n, r))
        pool_i = ids((nq, ef))
        pool_d = torch.where(pool_i >= 0,
                             torch.randint(0, 10 * m, (nq, ef), generator=g,
                                           device=dev).float(),
                             float("inf")).sort(1).values
        pool_v = torch.rand((nq, ef), generator=g, device=dev) < 0.5
        for kind, lut in luts.items():
            sel = ids((nq,))
            live = sel >= 0
            nbrs[sel[live].long(), :8] = pool_i[live, :8]   # duplicates
            args = (sel, nbrs, pool_i, pool_d, pool_v, lut, codes)
            got = beam_hop_lut_cuda(*args)
            want = beam_hop_ref(*args, dist_backend="pq")
            worst["beam_hop_lut"] = max(worst["beam_hop_lut"],
                                        err(got[1], want[1]))
            if not all(torch.equal(a_, b_) for a_, b_ in zip(got, want)):
                raise AssertionError(f"beam_hop LUT mode (M={m}) differs "
                                     f"from its plain version ({kind} "
                                     f"data): ids, dists, visited or stats")
        sels = Cycle([ids((nq,)) for _ in range(8)])
        ms = time_ms(lambda: beam_hop_lut_cuda(sels.next(), nbrs, pool_i,
                                               pool_d, pool_v, lut, codes))
        hop_dev_ms = queued_ms(torch, lambda: beam_hop_lut_cuda(
            sels.next(), nbrs, pool_i, pool_d, pool_v, lut, codes))
        plain = time_ms(lambda: beam_hop_ref(sels.next(), nbrs, pool_i,
                                             pool_d, pool_v, lut, codes,
                                             "pq"))
        moved = 0.0
        for s in sels.items:
            cand = torch.where((s >= 0)[:, None],
                               nbrs[s.clamp_min(0).long()], -1)
            moved += lut_bytes(torch, codes, cand, m) / 8
        bmin, by = bound(moved + nq * r * 4 + 2 * nq * ef * 9 + nq * 12,
                         nq * r * m, gpu)
        out["beam_hop_lut"][m] = dict(ms=ms, device_ms=hop_dev_ms,
                                      plain_ms=plain, bound_ms=bmin,
                                      bound_by=by, library_ms=None,
                                      shape=dict(q=nq, ef=ef, r=r, m=m,
                                                 c=LUT_C, n=n))
        del luts, codes, nbrs

    src = {"lut_dist": ("src/repro_torch/csrc/lut_dist.cu",
                        "src/repro/kernels/lut_dist/lut_dist.py:47"),
           "beam_hop_lut": ("src/repro_torch/csrc/beam_hop.cu",
                            "src/repro/kernels/beam_hop/beam_hop.py:117")}
    res = {}
    for name, by_m in out.items():
        head = by_m[LUT_MS[0]]
        res[name] = dict(route="cuda", source=src[name][0],
                         replaces=src[name][1], max_abs_err=worst[name],
                         **{k_: v for k_, v in head.items() if k_ != "shape"},
                         shape=head["shape"],
                         by_m={str(m): v for m, v in by_m.items()})
    return res


def hop_loop_phase(torch, n: int, d: int, gpu: str, seed: int) -> dict:
    """beam_hops, the hop loop kernel, at the serving shape (Q = 1024, ef =
    64, R = 32, the config's max_iters = 4 ef, while mode) over a random
    graph of the projected base's size: f32 at D = d on normal rows, and
    LUT mode at M = 300 (pq) and M = 600 (int8) on uniform codes and a
    float LUT, each on the variant ``beam_hop.route`` picks (persistent).
    Each must equal the host loop over the one-hop kernel (beam_hop_cuda /
    beam_hop_lut_cuda, core.beam_search._run_hops) in every field of the
    loop state, bit for bit; f32 also with patience 5. Timed per call from
    the seeded state (ms: one event-timed call; device_ms: queued_ms)
    beside the plain loop (beam_hops_ref on the card); the LUT loop also on
    the per_query variant (the block-per-query design) as
    ``per_query_device_ms``. The bound counts what this run's search must
    read: each distinct row the kernel scores (f32: D * 4 B; LUT: its M
    code bytes and each distinct LUT entry it looks up, 4 B), each distinct
    expanded graph row, the queries or LUT rows read, and the loop state in
    and out. Then a LUT shape the persistent variant cannot take (M =
    PER_QUERY_M: its staging buffer exceeds a block's shared memory) must
    route to per_query and equal the host loop and beam_hops_ref."""
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.beam_search import _expand_fused, _run_hop_slices, \
        _run_hops, _seed_batched
    from repro_torch.kernels.beam_hop import beam_hops_cuda, \
        beam_hops_lut_cuda, beam_hops_ref, select_frontier
    from repro_torch.kernels.beam_hop.beam_hop import LutPlan, _card, route
    from repro_torch.kernels.gather_dist import gather_dist_cuda
    from repro_torch.kernels.lut_dist import lut_dist_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 707)
    nq, ef, r = HOP_SHAPE["q"], HOP_SHAPE["ef"], HOP_SHAPE["r"]
    max_iters, k = 4 * ef, CONFIG.k
    nbrs = torch.randint(-1, n, (n, r), generator=g, device=dev,
                         dtype=torch.int32)
    entry = torch.randint(0, n, (nq,), generator=g, device=dev,
                          dtype=torch.int32)
    res, lut_by_m = {}, {}
    for name, m in [("beam_hops", None)] + [("beam_hops_lut", m_)
                                            for m_ in LUT_MS]:
        if m is None:
            backend, width = "f32", d
            table = torch.randn((n, d), generator=g, device=dev)
            q_or_lut = torch.randn((nq, d), generator=g, device=dev)
            gd, wrapper = gather_dist_cuda, beam_hops_cuda
        else:
            backend, width = "pq", m
            table = torch.randint(0, LUT_C, (n, m), generator=g, device=dev,
                                  dtype=torch.uint8)
            q_or_lut = torch.rand((nq, m, LUT_C), generator=g,
                                  device=dev) * 10
            gd = lambda q_, db_, ids: lut_dist_cuda(q_or_lut, table, ids)
            wrapper = beam_hops_lut_cuda
        state = _seed_batched(q_or_lut, table, nbrs, entry, ef, gd)
        # what the search reads: rows scored, LUT entries looked up,
        # expanded graph rows (marked while the host loop runs)
        scored = torch.zeros(n, dtype=torch.bool, device=dev)
        expanded = torch.zeros(n, dtype=torch.bool, device=dev)
        looked_up = (None if m is None else torch.zeros(
            (nq, m, LUT_C), dtype=torch.bool, device=dev))

        def body(s):
            _, node, active = select_frontier(s[0], s[1], s[2])
            lanes = (active & (s[3] < max_iters)).nonzero()[:, 0]
            expanded[node[lanes].long()] = True
            rows = nbrs[node[lanes].long()]                       # (L, R)
            new = (rows >= 0) & ~(rows[:, :, None]
                                  == s[0][lanes][:, None, :]).any(-1)
            scored[rows[new].long()] = True
            if looked_up is not None:
                lane_of = lanes[:, None].expand_as(rows)[new]
                codes = table[rows[new].long()].long()            # (S, M)
                looked_up[lane_of[:, None], torch.arange(m, device=dev),
                          codes] = True
            return _expand_fused(s, q_or_lut, table, nbrs, backend)

        kw = dict(k=k, max_iters=max_iters, mode="while", eps=0.0)
        checks = [None] + ([5] if m is None else [])
        by_variant = (None if m is None
                      else dict(beam_hops_lut_cuda.by_variant))
        for patience in checks:
            want = _run_hops(state, body if patience is None else
                             (lambda s: _expand_fused(s, q_or_lut, table,
                                                      nbrs, backend)),
                             patience=patience, **kw)
            got = _run_hop_slices(state, q_or_lut, table, nbrs, backend,
                                  max_steps=max_iters, patience=patience,
                                  **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} (width {width}) differs from "
                                     f"the host loop over the one-hop "
                                     f"kernel (patience {patience})")
            if patience is None:
                stats = want
        if m is not None and (beam_hops_lut_cuda.by_variant["persistent"]
                              == by_variant["persistent"]):
            raise AssertionError(f"the LUT loop at M={m} did not run on the "
                                 f"persistent variant")
        call = lambda **plan: wrapper(
            nbrs, *state[:6], state[7], q_or_lut, table, k=k,
            max_iters=max_iters, max_steps=max_iters, **plan)
        plain_call = lambda: beam_hops_ref(
            nbrs, *state[:6], state[7], q_or_lut, table, k=k,
            max_iters=max_iters, max_steps=max_iters)
        ms = time_ms(call, reps=9, warmup=2)
        dev_ms = queued_ms(torch, call)
        per_query = (None if m is None else queued_ms(
            torch, lambda: call(plan=LutPlan("per_query", 0, 0))))
        plain = time_ms(plain_call, reps=3, warmup=1)
        hops, gath, dup = (int(t.sum()) for t in stats[3:6])
        n_scored = int(scored.sum())
        state_bytes = 2 * nq * ef * 9 + nq * (4 + 6) * 4
        graph_bytes = int(expanded.sum()) * r * 4
        if m is None:
            moved = n_scored * d * 4 + nq * d * 4
            ops = 3 * (gath - dup) * d
        else:
            moved = n_scored * m + int(looked_up.sum()) * 4
            ops = (gath - dup) * m
        bmin, by = bound(moved + graph_bytes + state_bytes, ops, gpu)
        entry_ = dict(
            route="cuda", source="src/repro_torch/csrc/beam_hop.cu",
            replaces="src/repro/kernels/beam_hop/beam_hop.py:117",
            max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain,
            bound_ms=bmin, bound_by=by, share_of_bound=bmin / dev_ms,
            library_ms=None, hops=hops, gathered=gath, dup_gathered=dup,
            rows_scored_distinct=n_scored,
            loop_iterations=int((stats[3] + stats[6]).max()),
            shape=dict(q=nq, ef=ef, r=r, n=n, max_iters=max_iters,
                       **({"d": d} if m is None else {"m": m, "c": LUT_C})))
        if m is None:
            res[name] = entry_
        else:
            entry_.update(per_query_device_ms=per_query,
                          plan=route(m, LUT_C, r, ef,
                                     *_card(dev))._asdict())
            lut_by_m[m] = entry_
        del table, q_or_lut, scored, looked_up, state
    head = lut_by_m[LUT_MS[0]]
    res["beam_hops_lut"] = dict(
        {k_: v for k_, v in head.items() if k_ != "shape"},
        shape=head["shape"], by_m={str(m): v for m, v in lut_by_m.items()},
        per_query_route=per_query_route_check(torch, seed))
    return res


def per_query_route_check(torch, seed: int) -> dict:
    """A LUT loop the persistent variant cannot take (M = PER_QUERY_M, C =
    256: its staging buffer alone exceeds a block's shared memory) on a
    small random graph: ``route`` must pick per_query, the wrapper must
    count it there, and the result must equal the host loop over the
    one-hop kernel and beam_hops_ref in every output."""
    from repro_torch.core.beam_search import _expand_fused, _run_hop_slices, \
        _run_hops, _seed_batched
    from repro_torch.kernels.beam_hop import beam_hops_lut_cuda, \
        beam_hops_ref
    from repro_torch.kernels.beam_hop.beam_hop import _card, route
    from repro_torch.kernels.lut_dist import lut_dist_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 808)
    nq, n, r, ef, m = 64, 4096, HOP_SHAPE["r"], HOP_SHAPE["ef"], PER_QUERY_M
    plan = route(m, LUT_C, r, ef, *_card(dev))
    if plan.variant != "per_query":
        raise AssertionError(f"route sent M={m} to {plan}, not per_query")
    nbrs = torch.randint(-1, n, (n, r), generator=g, device=dev,
                         dtype=torch.int32)
    codes = torch.randint(0, LUT_C, (n, m), generator=g, device=dev,
                          dtype=torch.uint8)
    lut = torch.rand((nq, m, LUT_C), generator=g, device=dev) * 10
    entry = torch.randint(0, n, (nq,), generator=g, device=dev,
                          dtype=torch.int32)
    state = _seed_batched(lut, codes, nbrs, entry, ef,
                          lambda q_, db_, ids: lut_dist_cuda(lut, codes, ids))
    kw = dict(k=10, max_iters=4 * ef, eps=0.0)
    before = beam_hops_lut_cuda.by_variant["per_query"]
    want = _run_hops(state, lambda s: _expand_fused(s, lut, codes, nbrs,
                                                    "pq"), mode="while",
                     patience=None, **kw)
    got = _run_hop_slices(state, lut, codes, nbrs, "pq", mode="while",
                          patience=None, max_steps=4 * ef, **kw)
    args = (nbrs, *state[:6], state[7], lut, codes)
    got9 = beam_hops_lut_cuda(*args, max_steps=4 * ef, **kw)
    want9 = beam_hops_ref(*args, max_steps=4 * ef, **kw)
    if beam_hops_lut_cuda.by_variant["per_query"] - before != 2:
        raise AssertionError("the per_query launches were not counted")
    if not (all(torch.equal(a, b) for a, b in zip(got, want))
            and all(torch.equal(a, b) for a, b in zip(got9, want9))):
        raise AssertionError(f"the per_query LUT loop (M={m}) differs from "
                             f"the host loop or beam_hops_ref")
    return dict(m=m, c=LUT_C, q=nq, n=n, plan=plan._asdict(),
                hops=int(want[3].sum()), equal=True)


def mode_kernel_phase(torch, n: int, d: int, gpu: str, seed: int) -> dict:
    """gather_dist and beam_hops in the sharded tier's modes (MODE_NAMES:
    bf16 rows, the prenorm distance, both) at the hop-loop check shape
    (HOP_SHAPE, D = d, a random graph over n rows of normal data, norms of
    the f32 rows). Each must equal its plain version on the card bit for
    bit: the plain versions sum in the kernels' lane order
    (kernels/gather_dist/ref.py). gather_dist at B = 1024, R = 32 over 8
    id sets; the loop over one whole 1024-query search from a pool seeded
    by gather_dist in the mode, against the host loop over the plain hop
    (beam_hop_ref in the mode), which marks each row it scores. The bound
    counts what the call must read: each distinct row at the mode's bytes
    (bf16: 2 B an element) and, under prenorm, its 4 B norm; the queries;
    for the loop the expanded graph rows and the state in and out. Returns
    {"gather_dist": {mode: entry}, "beam_hops": {mode: entry}}."""
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.beam_search import _run_hop_slices, _run_hops, \
        _seed_batched
    from repro_torch.kernels.beam_hop import beam_hop_ref, beam_hops_cuda, \
        beam_hops_ref, select_frontier
    from repro_torch.kernels.gather_dist import gather_dist_cuda, \
        gather_dist_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 909)
    nq, ef, r = HOP_SHAPE["q"], HOP_SHAPE["ef"], HOP_SHAPE["r"]
    max_iters, k = 4 * ef, CONFIG.k
    base = torch.randn((n, d), generator=g, device=dev)
    all_norms = (base * base).sum(-1)
    rows16 = base.bfloat16()
    q = torch.randn((nq, d), generator=g, device=dev)
    nbrs = torch.randint(-1, n, (n, r), generator=g, device=dev,
                         dtype=torch.int32)
    entry = torch.randint(0, n, (nq,), generator=g, device=dev,
                          dtype=torch.int32)
    sets = Cycle([torch.randint(-1, n, (nq, r), generator=g, device=dev,
                                dtype=torch.int32) for _ in range(8)])
    uniq = sum(int(torch.unique(x[x >= 0]).numel()) for x in sets.items) / 8
    out = {"gather_dist": {}, "beam_hops": {}}
    for mode in MODE_NAMES:
        db = rows16 if mode.startswith("bf16") else base
        norms = all_norms if mode.endswith("prenorm") else None
        row_bytes = d * db.element_size() + (4 if norms is not None else 0)
        flops = (2 if norms is not None else 3) * d     # per scored row
        # gather_dist
        for x in sets.items:
            if not bits_equal(torch, gather_dist_cuda(q, db, x, norms),
                              gather_dist_ref(q, db, x, norms)):
                raise AssertionError(f"gather_dist ({mode}) differs from "
                                     f"its plain version")
        ms = time_ms(lambda: gather_dist_cuda(q, db, sets.next(), norms))
        dev_ms = queued_ms(torch, lambda: gather_dist_cuda(
            q, db, sets.next(), norms))
        plain = time_ms(lambda: gather_dist_ref(q, db, sets.next(), norms),
                        reps=5, warmup=1)
        bmin, by = bound(uniq * row_bytes + nq * d * 4 + nq * r * 8,
                         nq * r * flops, gpu)
        out["gather_dist"][mode] = dict(
            max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain,
            bound_ms=bmin, bound_by=by, share_of_bound=bmin / dev_ms,
            library_ms=None, distinct_rows=uniq)

        # beam_hops over one search
        gd = lambda q_, db_, ids: gather_dist_cuda(q_, db_, ids, norms)
        state = _seed_batched(q, db, nbrs, entry, ef, gd)
        scored = torch.zeros(n, dtype=torch.bool, device=dev)
        expanded = torch.zeros(n, dtype=torch.bool, device=dev)

        def body(s):
            pool_i, pool_d, pool_v, hops, gath, dup = s
            pool_v, node, active = select_frontier(pool_i, pool_d, pool_v)
            lanes = (active & (hops < max_iters)).nonzero()[:, 0]
            expanded[node[lanes].long()] = True
            rows = nbrs[node[lanes].long()]
            new = (rows >= 0) & ~(rows[:, :, None]
                                  == pool_i[lanes][:, None, :]).any(-1)
            scored[rows[new].long()] = True
            sel = torch.where(active, node, -1).to(torch.int32)
            pool_i, pool_d, pool_v, st = beam_hop_ref(
                sel, nbrs, pool_i, pool_d, pool_v, q, db, "f32", norms)
            return (pool_i, pool_d, pool_v, hops + active.to(torch.int32),
                    gath + st[:, 0], dup + st[:, 1])

        kw = dict(k=k, max_iters=max_iters, mode="while", patience=None,
                  eps=0.0)
        want = _run_hops(state, body, **kw)
        got = _run_hop_slices(state, q, db, nbrs, "f32", max_steps=max_iters,
                              norms=norms, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"beam_hops ({mode}) differs from the host "
                                 f"loop over the plain hop")
        call = lambda: beam_hops_cuda(
            nbrs, *state[:6], state[7], q, db, k=k, max_iters=max_iters,
            max_steps=max_iters, norms=norms)
        plain_call = lambda: beam_hops_ref(
            nbrs, *state[:6], state[7], q, db, k=k, max_iters=max_iters,
            max_steps=max_iters, norms=norms)
        ms = time_ms(call, reps=9, warmup=2)
        dev_ms = queued_ms(torch, call)
        plain = time_ms(plain_call, reps=1, warmup=0)
        hops, gath, dup = (int(t.sum()) for t in want[3:6])
        n_scored = int(scored.sum())
        moved = (n_scored * row_bytes + nq * d * 4
                 + int(expanded.sum()) * r * 4
                 + 2 * nq * ef * 9 + nq * (4 + 6) * 4)
        bmin, by = bound(moved, (gath - dup) * flops, gpu)
        out["beam_hops"][mode] = dict(
            max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain,
            bound_ms=bmin, bound_by=by, share_of_bound=bmin / dev_ms,
            library_ms=None, hops=hops, gathered=gath, dup_gathered=dup,
            rows_scored_distinct=n_scored,
            loop_iterations=int((want[3] + want[6]).max()))
        del state, want, got, scored, expanded
    return out


def l2topk_shapes() -> dict:
    """The l2topk calls of the main path, from the ann-laion config, and a
    FlatIndex search at wide k over the same raw base: name -> (Q, N, D,
    k)."""
    from repro_torch.configs.ann_laion import ANN_SHAPES, CONFIG
    from repro_torch.core.quant import default_pq_m
    n, d0, d = CONFIG.n_database, CONFIG.dim, CONFIG.pca_dim
    n_kept = max(1, math.ceil(CONFIG.antihub_keep * n))
    chunk = ANN_SHAPES["build_knn"].batch          # knn_graph's query chunk
    batch = ANN_SHAPES["search_300k"].batch
    return {
        "antihub": (chunk, n, d0, 11),             # raw 10-NN (+ self)
        "knn": (chunk, n_kept, d, CONFIG.build_knn_k + 1),
        "ground_truth": (batch, n, d0, CONFIG.k),
        "kmeans": (n_kept, CONFIG.ep_clusters, d, 1),
        "medoid": (1, n_kept, d, 1),
        "entry_select": (batch, CONFIG.ep_clusters, d, 1),
        "pq": (n_kept, 256, d // default_pq_m(d), 1),
        # FlatIndex.search at k past the tile variant's lists: the one
        # call here that is not on the main path
        "flat_wide": (batch, n, d0, FLAT_WIDE_K),
    }


def wide_ids_hold(torch, qs, x, gd, gi, chunk: int = 128) -> bool:
    """At wide k a float near-tie inside the list is likely and the kernel
    and the plain version round differently, so there the ids are held by
    what they are: unique in each row, and each id's own distance
    (recomputed by the plain formula) within rtol = atol = 1e-5 of the
    distance returned beside it."""
    from repro_torch.kernels.l2topk.ref import pairwise_sqdist
    srt = torch.sort(gi, dim=1).values
    if not bool((srt[:, 1:] != srt[:, :-1]).all()):
        return False
    for s in range(0, qs.shape[0], chunk):
        ids = gi[s:s + chunk].long()
        own = pairwise_sqdist(qs[s:s + chunk, None, :], x[ids]).squeeze(1)
        ref = gd[s:s + chunk]
        if not bool(((own - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()):
            return False
    return True


def l2topk_kernel_phase(torch, gpu: str, seed: int) -> dict:
    """l2topk at each of its main-path shapes against its plain version:
    integer inputs in [-1, 1] (many tied distances) must give the same ids
    and the same dist bits; float inputs dists within rtol = atol = 1e-5
    and ids equal on >= 99% of rows (the kernel sums each dot product in
    another order than cuBLAS). Each shape must take the variant
    L2TOPK_ROUTES names, and only that variant may count the launches.
    At the wide shape (k = 256) float ids are held by wide_ids_hold
    instead of row equality: near-ties inside 256 entries are common.
    Both are timed with CUDA events (ms: one call, host launch included;
    device_ms: queued_ms); the plain version is the route the main path took
    before this kernel (chunked torch.matmul + packed-key torch.topk), not a
    yardstick of its speed. The bounds: bytes against the f32 rate outside
    the tensor cores (bound_f32_ms) and against 3 TF32 products per
    multiply-add on them (bound_3xtf32_ms); bound_ms is the one of the
    arithmetic the variant runs. No single PyTorch call computes a top-k of
    distances: no library time."""
    from repro_torch.kernels.l2topk import l2_topk_ref, l2topk_cuda
    from repro_torch.kernels.l2topk.l2topk import variant_for

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 202)
    out, worst = {}, 0.0
    for name, (q, n, d, k) in l2topk_shapes().items():
        variant = variant_for(q, n, d, min(k, n))
        if variant != L2TOPK_ROUTES[name]:
            raise AssertionError(f"l2topk ({name}) routes to {variant}, "
                                 f"not {L2TOPK_ROUTES[name]}")
        for kind in ("int", "float"):
            if kind == "int":
                x = torch.randint(-1, 2, (n, d), generator=g,
                                  device=dev).float()
                qs = torch.randint(-1, 2, (q, d), generator=g,
                                   device=dev).float()
            else:
                x = torch.randn((n, d), generator=g, device=dev)
                qs = torch.randn((q, d), generator=g, device=dev)
            before = dict(l2topk_cuda.by_variant)
            gd, gi = l2topk_cuda(qs, x, k)
            launched = [v for v, c in l2topk_cuda.by_variant.items()
                        if c != before[v]]
            if launched != [variant]:
                raise AssertionError(f"l2topk ({name}) launched {launched}, "
                                     f"expected the {variant} variant")
            wd, wi = l2_topk_ref(qs, x, k)
            if gi.shape != (q, min(k, n)):
                raise AssertionError(f"l2topk ({name}) shape {gi.shape}")
            if kind == "int":
                if not (torch.equal(gi, wi) and torch.equal(
                        gd.view(torch.int32), wd.view(torch.int32))):
                    raise AssertionError(f"l2topk ({name}) differs from its "
                                         f"plain version on integer data")
            else:
                err = (gd - wd).abs()
                rows = float((gi == wi).all(1).float().mean())
                if not bool((err <= 1e-5 + 1e-5 * wd.abs()).all()) or (
                        rows < 0.99 if variant != "wide"
                        else not wide_ids_hold(torch, qs, x, gd, gi)):
                    raise AssertionError(
                        f"l2topk ({name}): dists beyond rtol 1e-5 or ids "
                        f"equal on {rows:.4f} of rows")
                worst = max(worst, float(err.max()))
        big = q * n * d > 1e11
        reps, warm = (5, 1) if big else (25, 3)
        ms = time_ms(lambda: l2topk_cuda(qs, x, k), reps, warm)
        dev_ms = queued_ms(torch, lambda: l2topk_cuda(qs, x, k))
        plain = time_ms(lambda: l2_topk_ref(qs, x, k), reps, warm)
        moved = (q + n) * d * 4 + q * k * 8
        b32, by32 = bound(moved, 2 * q * n * d + 2 * (q + n) * d, gpu)
        btc, bytc = bound(moved, 3 * 2 * q * n * d, gpu, PEAK_TF32)
        bmin, by = (btc, bytc) if variant == "tc" else (b32, by32)
        out[name] = dict(variant=variant, ms=ms, device_ms=dev_ms,
                         plain_ms=plain, bound_ms=bmin, bound_by=by,
                         share_of_bound=bmin / dev_ms,
                         bound_f32_ms=b32, bound_f32_by=by32,
                         bound_3xtf32_ms=btc, bound_3xtf32_by=bytc,
                         library_ms=None,
                         shape=dict(q=q, n=n, d=d, k=k))
        del x, qs
    head = out["antihub"]
    return dict(route="cuda", source="src/repro_torch/csrc/l2topk.cu",
                replaces="src/repro/kernels/l2topk/l2topk.py:93",
                max_abs_err=worst,
                **{k_: v for k_, v in head.items() if k_ != "shape"},
                shape=head["shape"], by_shape=out,
                plain_is="the pre-PR route of the main path (chunked "
                         "torch.matmul + packed-key torch.topk)")


def profile_busy(torch, fn) -> dict:
    """Device-busy milliseconds of one ``fn()`` call from a torch.profiler
    trace (kernels on one stream do not overlap, so their durations add),
    with the kernels that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"device_busy_ms": busy_ms if by_name else None,
            "profiled_wall_ms": wall * 1e3,
            "device_kernels": sum(v[1] for v in by_name.values()),
            "top_kernels": [{"name": n[:60], "ms": v[0] / 1e3, "count": v[1]}
                            for n, v in top]}


def per_search(torch, wrappers: dict, fn) -> dict:
    """The hand-written kernels' launches (those that launched) and the hop
    loops' host syncs (core.beam_search's count) of one ``fn()`` call."""
    from repro_torch.core.beam_search import beam_search
    before = {name: w.launches for name, w in wrappers.items()}
    syncs = beam_search.host_syncs
    fn()
    torch.cuda.synchronize()
    return {"launches": {name: w.launches - before[name]
                         for name, w in wrappers.items()
                         if w.launches != before[name]},
            "host_syncs": beam_search.host_syncs - syncs}


def quantized_phase(torch, index, queries, true_i, backend: str,
                    wrappers: dict, seed: int) -> dict:
    """Quantize the fitted index with ``backend`` (PQ's k-means++ seeds
    drawn from ``seed``) and serve the queries through the fused LUT hop
    with the config's exact rerank; check the staged hop and the CPU.
    Returns the launches of every kernel over quantize + serve (the counts
    are zeroed just before and read just after)."""
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.pipeline import TunedGraphIndex
    from repro_torch.kernels.lut_dist.lut_dist import route as lut_route

    k, ef, rerank = CONFIG.k, CONFIG.ef_search, CONFIG.rerank
    n_queries = queries.shape[0]
    kw = dict(ef=ef, rerank=rerank, dist_backend=backend)
    torch.cuda.synchronize()
    zero_counts(wrappers)
    t = time.perf_counter()
    index.quantize(backend, generator=torch.Generator().manual_seed(seed))
    quantize_s = time.perf_counter() - t
    index.search(queries, k, hop_backend="fused", **kw)            # warm
    times = []
    for _ in range(SERVE_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d_f, i_f = index.search(queries, k, hop_backend="fused", **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    stats_f = index.search_stats()
    prof = profile_busy(torch, lambda: index.search(
        queries, k, hop_backend="fused", **kw))
    launches = {name: w.launches for name, w in wrappers.items()}
    launches["l2topk_by_variant"] = dict(wrappers["l2topk"].by_variant)
    launches["lut_loop_by_variant"] = dict(
        wrappers["beam_hops_lut"].by_variant)
    launches["lut_dist_by_variant"] = dict(wrappers["lut_dist"].by_variant)
    one = per_search(torch, wrappers, lambda: index.search(
        queries, k, hop_backend="fused", **kw))
    serve_s = statistics.median(times)
    busy = prof["device_busy_ms"]
    iters = (stats_f["hops"] + stats_f["wasted_hops"]) / n_queries
    recall = recall_at_k(i_f.cpu(), true_i.cpu())
    emit("quantized", backend=backend, quantize_seconds=quantize_s,
         codec_seconds=index.quantize_seconds,
         code_bytes=index.codes.numel() * index.codes.element_size(),
         codes_shape=list(index.codes.shape),
         memory_bytes=index.memory_bytes(), queries=n_queries, k=k, ef=ef,
         rerank=rerank, runs=SERVE_RUNS, qps=n_queries / serve_s,
         qps_min=n_queries / max(times), qps_max=n_queries / min(times),
         seconds=serve_s, recall_at_10=recall, stats=stats_f,
         loop_iterations=iters, ms_per_iteration=serve_s * 1e3 / iters,
         device_busy_share=None if busy is None else busy / (serve_s * 1e3),
         profile=prof, launches=launches, per_search=one)
    if not (torch.isfinite(d_f).all() and i_f.shape == (n_queries, k)):
        raise AssertionError(f"{backend} search returned non-finite or "
                             f"mis-shaped results")
    if recall < 0.80:
        raise AssertionError(f"{backend} recall@10 {recall} below the "
                             f"0.80 floor")
    if one["launches"].get("beam_hops_lut") != 1 or one["host_syncs"] != 1:
        raise AssertionError(f"a fused {backend} search took {one}, not one "
                             f"loop launch and one host sync")
    if (launches["lut_loop_by_variant"]["per_query"] != 0
            or launches["lut_loop_by_variant"]["persistent"]
            != launches["beam_hops_lut"]):
        raise AssertionError(f"the {backend} searches did not all run the "
                             f"persistent LUT loop: "
                             f"{launches['lut_loop_by_variant']}")
    # the pool seed's (Q, 1) LUT distances: one call per search, each on
    # the variant lut_dist's route names for Q pairs
    seed_variant = lut_route(n_queries)
    if launches["lut_dist"] <= 0 or launches["lut_dist_by_variant"] != {
            v: launches["lut_dist"] if v == seed_variant else 0
            for v in launches["lut_dist_by_variant"]}:
        raise AssertionError(f"the {backend} pool seeds did not all run "
                             f"lut_dist's {seed_variant} variant: "
                             f"{launches['lut_dist_by_variant']}")

    # the staged LUT hop equals the fused one, bit for bit
    d_s, i_s = index.search(queries, k, hop_backend="staged", **kw)
    stats_s = index.search_stats()
    same = (torch.equal(d_s, d_f) and torch.equal(i_s, i_f)
            and stats_s == stats_f)
    # REF_QUERIES of the queries on the CPU, from the saved state (plain
    # versions of every kernel): the projection's matmul rounds otherwise,
    # so ids on >= 99% of rows and dists to rtol = atol = 1e-5
    cpu_index = TunedGraphIndex.from_state(index.state_dict(), device="cpu")
    nq = min(REF_QUERIES, n_queries)
    d_c, i_c = cpu_index.search(queries[:nq].cpu(), k, hop_backend="fused",
                                **kw)
    rows = float((i_c == i_f[:nq].cpu()).all(1).float().mean())
    close = torch.allclose(d_c, d_f[:nq].cpu(), rtol=1e-5, atol=1e-5)
    emit("quantized_checks", backend=backend, staged_equal_to_fused=same,
         staged_stats=stats_s, cpu_queries=nq, cpu_ids_equal_rows=rows,
         cpu_dists_close=close,
         cpu_max_abs_err=float((d_c - d_f[:nq].cpu()).abs().max()))
    if not same:
        raise AssertionError(f"{backend}: staged hop differs from the fused "
                             f"hop")
    if rows < 0.99 or not close:
        raise AssertionError(f"{backend}: the card's search disagrees with "
                             f"the plain PyTorch versions on the CPU")
    return launches


def check_scans(phase: str, fit_launches: dict, n_kept: int) -> None:
    """A fit's α-scans take one alpha_scan launch per chunk: 2048-row
    chunks of the prune stage and of the interconnect's re-prune."""
    want = 2 * math.ceil(n_kept / SCAN_CHUNK)
    if fit_launches["alpha_scan"] != want:
        raise AssertionError(f"{phase}: {fit_launches['alpha_scan']} "
                             f"alpha_scan launches in the fit, expected "
                             f"{want} (one per chunk of both scans)")


def fit_auto_phase(torch, data, queries, true_i, wrappers: dict,
                   seed: int, exact_recall: float) -> dict:
    """ann-laion fitted as its config says (IndexParams.from_config(CONFIG)
    unmodified: NN-Descent for the AntiHub and the structural kNN tables,
    the subset reuse, table pools, the device finish), then served. Returns
    the launches of every kernel over the fit and its searches (zeroed just
    before the fit, read just after the last search)."""
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.build import knn_graph_recall
    from repro_torch.core.build.finish import propagate_reach, reachable_mask
    from repro_torch.core.knn_graph import knn_graph
    from repro_torch.core.pipeline import IndexParams, TunedGraphIndex

    params = IndexParams.from_config(CONFIG)
    torch.cuda.synchronize()
    zero_counts(wrappers)
    steps0 = propagate_reach.steps
    t = time.perf_counter()
    index = TunedGraphIndex(params, device="cuda").fit(
        data, torch.Generator().manual_seed(seed))
    fit_s = time.perf_counter() - t
    fit_launches = {name: w.launches for name, w in wrappers.items()}
    by_mode = {m: dict(c) for m, c in wrappers["topk_merge"].by_mode.items()}
    scan_by_variant = dict(wrappers["alpha_scan"].by_variant)
    reach_steps = propagate_reach.steps - steps0
    k, ef = CONFIG.k, CONFIG.ef_search
    index.search(queries, k, ef=ef)                              # warm
    times = []
    for _ in range(SERVE_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d_a, i_a = index.search(queries, k, ef=ef)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {name: w.launches for name, w in wrappers.items()}
    launches["topk_merge_by_mode"] = by_mode
    launches["l2topk_by_variant"] = dict(wrappers["l2topk"].by_variant)
    launches["alpha_scan_by_variant"] = scan_by_variant
    recall = recall_at_k(i_a.cpu(), true_i.cpu())
    serve_s = statistics.median(times)
    # the kNN table against the exact 32-NN of the same base (l2topk)
    t = time.perf_counter()
    _, exact_ids = knn_graph(index.base, params.build_knn_k)
    table_recall = knn_graph_recall(index.knn_ids, exact_ids)
    exact_s = time.perf_counter() - t
    reach = reachable_mask(index.graph.neighbors, index.graph.medoid)
    bs = index.build_stats
    emit("fit_auto", seconds=fit_s, n=data.shape[0], n_kept=index.ntotal,
         knn_backend=params.knn_backend,
         pools_backend=bs.pools_backend, finish_backend=bs.finish_backend,
         stage_seconds=index.stage_seconds, knn_seconds=index.knn_seconds,
         interconnect_seconds=bs.interconnect_seconds,
         repair_seconds=bs.repair_seconds,
         knn_stats={name: st._asdict()
                    for name, st in index.knn_stats.items()},
         knn_table_recall=table_recall, exact_knn_seconds=exact_s,
         pool_evals=bs.pool_evals, prune_evals=bs.prune_evals,
         repair_rounds=bs.repair_rounds, reach_steps=reach_steps,
         reachable=float(reach.float().mean()), launches=fit_launches,
         topk_merge_launches_by_mode=by_mode,
         queries=queries.shape[0], k=k, ef=ef, recall_at_10=recall,
         exact_host_recall_at_10=exact_recall,
         qps=queries.shape[0] / serve_s,
         qps_min=queries.shape[0] / max(times),
         qps_max=queries.shape[0] / min(times),
         recall_floor=FIT_AUTO_RECALL_FLOOR,
         table_recall_floor=FIT_AUTO_TABLE_RECALL_FLOOR,
         baseline_seed0=BASELINE_SEED0,
         peak_device_bytes=torch.cuda.max_memory_allocated())
    if (params.knn_backend, bs.pools_backend, bs.finish_backend) != (
            "auto", "nndescent", "device") or set(index.knn_stats) != {
            "antihub", "knn"} or any(st.backend != "nndescent"
                                     for st in index.knn_stats.values()):
        raise AssertionError("fit_auto: the config's backends did not "
                             "resolve to NN-Descent, table pools and the "
                             "device finish")
    if not bool(reach.all()):
        raise AssertionError("fit_auto: a node is not reachable from the "
                             "medoid")
    if sum(c["block"] for c in by_mode.values()) or min(
            c["warp"] for c in by_mode.values()) <= 0:
        raise AssertionError(f"fit_auto: a topk_merge launch did not take "
                             f"the warp variant, or a mode never launched: "
                             f"{by_mode}")
    if not (torch.isfinite(d_a).all() and i_a.shape == (queries.shape[0],
                                                        k)):
        raise AssertionError("fit_auto: search returned non-finite or "
                             "mis-shaped results")
    check_scans("fit_auto", fit_launches, index.ntotal)
    if seed == 0 and launches["gather_dist"] != \
            BASELINE_SEED0["fit_auto_gather_dist"] - SCAN_LOOP_POSITIONS * \
            math.ceil(index.ntotal / SCAN_CHUNK):
        raise AssertionError(
            f"fit_auto: {launches['gather_dist']} gather_dist launches; "
            f"expected the baseline's {BASELINE_SEED0['fit_auto_gather_dist']}"
            f" less the per-position loop's")
    if seed == 0 and (round(recall, 5), round(table_recall, 5)) != (
            BASELINE_SEED0["fit_auto"], BASELINE_SEED0["knn_table"]):
        raise AssertionError(f"fit_auto: recall@10 {recall} or table recall "
                             f"{table_recall} moved from the baseline's at "
                             f"seed 0")
    if recall < FIT_AUTO_RECALL_FLOOR or \
            table_recall < FIT_AUTO_TABLE_RECALL_FLOOR:
        raise AssertionError(f"fit_auto: recall@10 {recall} or kNN-table "
                             f"recall {table_recall} below its floor")
    return launches


def tune_phase(torch, data, queries, wrappers: dict, seed: int) -> dict:
    """The paper's tuner on the phase-4 data: AnnObjective + a TPE study
    over default_space's rebuild-free knobs (the structural knobs held at
    the config's), single objective, recall floor 0.9. Returns the launches
    of every kernel over the phase (zeroed just before, read just after)."""
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.build import reprune_family, reprune_nsg
    from repro_torch.core.build.finish import reachable_from
    from repro_torch.core.pipeline import IndexParams, structural_build_count
    from repro_torch.core.tuning import (
        AnnObjective, SearchSpace, Study, TPESampler, default_space,
    )

    full = default_space(CONFIG.dim, CONFIG.n_database,
                         max_degree=CONFIG.graph_degree)
    space = SearchSpace()
    for name in ("graph_degree", "alpha", "ep_clusters", "ef_search",
                 "hop_backend", "patience"):
        space.add(name, full.params[name])
    base = IndexParams.from_config(CONFIG, knn_backend="exact",
                                   finish_backend="host",
                                   graph_degree=CONFIG.graph_degree)
    torch.cuda.synchronize()
    zero_counts(wrappers)
    builds0 = structural_build_count()
    t = time.perf_counter()
    obj = AnnObjective(data, queries, k=CONFIG.k, base_params=base,
                       recall_floor=0.9, qps_repeats=3, seed=seed,
                       device="cuda")
    gt_s = time.perf_counter() - t
    study = Study(space, TPESampler(seed=seed, n_startup=5))
    study.optimize(obj.single_objective, n_trials=TUNE_TRIALS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {name: w.launches for name, w in wrappers.items()}
    launches["l2topk_by_variant"] = dict(wrappers["l2topk"].by_variant)
    launches["topk_merge_by_variant"] = dict(
        wrappers["topk_merge"].by_variant)
    launches["alpha_scan_by_variant"] = dict(
        wrappers["alpha_scan"].by_variant)
    builds = structural_build_count() - builds0
    trials = [dict(params=params, recall=r.recall, qps=r.qps,
                   build_seconds=r.build_seconds, cached=r.cached_build,
                   repruned=r.repruned, mem_bytes=r.mem_bytes)
              for params, r in obj.eval_log]
    try:
        best = study.best_trial
        best = dict(number=best.number, params=best.params,
                    feasible=best.feasible,
                    recall=best.user_attrs["result"].recall,
                    qps=best.user_attrs["result"].qps)
    except ValueError:
        best = None
    grid_hits, family_prunes = obj.grid_hits, obj.family_prunes
    # the study's family pass again, timed alone: the same packed masks
    full_index = next(iter(obj._build_cache.values()))
    torch.cuda.synchronize()
    t = time.perf_counter()
    family = reprune_family(full_index.base, full_index.graph.neighbors,
                            obj.alpha_grid, materialize=False)
    torch.cuda.synchronize()
    family_s = time.perf_counter() - t
    family_same = torch.equal(
        family.masks, next(iter(obj._family_cache.values())).masks)

    # every trial's search again, through the objective's own caches: ids
    # well shaped and in range (the counters are restored afterwards)
    shapes_ok = True
    for params, _ in obj.eval_log:
        p = replace(obj.base, **params)
        idx, _, _ = obj._get_index(p)
        d_t, i_t = idx.search(queries, CONFIG.k, ef=max(p.ef_search,
                                                        CONFIG.k),
                              hop_backend=p.hop_backend,
                              patience=p.patience)
        shapes_ok &= bool(i_t.shape == (queries.shape[0], CONFIG.k)
                          and torch.isfinite(d_t).all()
                          and (i_t >= 0).all()
                          and (i_t < data.shape[0]).all())
    obj.grid_hits = grid_hits
    # derived graphs: reachable from the medoid; one equals reprune_nsg's
    graphs = list(obj._graph_cache.items())
    reach = [float(reachable_from(g.neighbors.cpu().numpy(),
                                  int(g.medoid)).mean()) for _, g in graphs]
    same_as_direct = None
    if graphs:
        gkey, g = graphs[0]
        degree, alpha = gkey[-2], gkey[-1]
        direct = reprune_nsg(full_index.base, full_index.graph, alpha=alpha,
                             degree=degree, knn_ids=full_index.knn_ids,
                             finish_backend="host")
        same_as_direct = dict(degree=degree, alpha=alpha, equal=bool(
            torch.equal(direct.neighbors, g.neighbors)
            and int(direct.medoid) == int(g.medoid)))
    emit("tune", seconds=seconds, ground_truth_and_setup_seconds=gt_s,
         trials=trials, structural_builds=builds,
         family_prunes=family_prunes, grid_hits=grid_hits,
         family_pass_seconds=family_s, family_pass_alphas=len(obj.alpha_grid),
         family_pass_equal=family_same,
         best_feasible=best, derived_graphs=len(graphs),
         derived_reachable=reach, reprune_check=same_as_direct,
         searches_well_shaped=shapes_ok, launches=launches)
    if builds != 1 or family_prunes != 1:
        raise AssertionError(f"tune: {builds} structural builds and "
                             f"{family_prunes} family passes, expected 1/1")
    if not family_same:
        raise AssertionError("tune: the family pass run again gave other "
                             "masks")
    if not graphs or same_as_direct is None or not same_as_direct["equal"]:
        raise AssertionError("tune: no repruned trial, or its graph differs "
                             "from reprune_nsg's")
    if min(reach) < 1.0:
        raise AssertionError("tune: a derived graph is not reachable from "
                             "the medoid")
    if not shapes_ok or len(trials) != TUNE_TRIALS:
        raise AssertionError("tune: a trial's search returned mis-shaped "
                             "or non-finite results")
    return launches


def tune_cli_phase(src: Path) -> None:
    """``python -m repro_torch.launch.tune`` at N=20000, D=768 as a
    subprocess: it must exit 0 and print its Pareto front and build log."""
    import os
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", *TUNE_CLI_ARGS],
        env={**os.environ, "PYTHONPATH": str(src)}, capture_output=True,
        text=True, timeout=TUNE_CLI_TIMEOUT)
    lines = proc.stdout.splitlines()
    front, log = [], []
    if "-- build log" in proc.stdout:
        cut = next(i for i, ln in enumerate(lines) if "-- build log" in ln)
        front = [ln for ln in lines[:cut] if ln.strip()]
        log = lines[cut:]
    emit("tune_cli", args=TUNE_CLI_ARGS, returncode=proc.returncode,
         seconds=time.perf_counter() - t, pareto_front=front, build_log=log,
         stderr_tail=proc.stderr[-2000:] if proc.returncode else "")
    if proc.returncode != 0 or len(front) < 2 or not any(
            "structural builds" in ln for ln in log):
        raise AssertionError("tune_cli: the tuner failed or printed no "
                             "Pareto front / build log")


class ScanRecorder:
    """Keeps the operands of the first and the last α-scan kernel call of
    each path shape (the key (L, per-row alpha)) whose key is in ``on``: it
    stands in for ``alpha_scan_cuda`` in ``kernels/alpha_scan/ops.py``,
    passes every call on to the wrapper (which launches and counts it) and
    copies nothing."""

    def __init__(self, torch, ops):
        self.tensor, self.ops, self.real = torch.Tensor, ops, \
            ops.alpha_scan_cuda
        self.calls, self.on = {}, set()
        ops.alpha_scan_cuda = self

    def __call__(self, *args, **kw):
        key = (args[2].shape[1], isinstance(args[5], self.tensor))
        if key in self.on:
            self.calls[key] = (self.calls.get(key, (args,))[0], args)
        return self.real(*args, **kw)


def scan_work(torch, data, node_ids, cand_ids, cand_dists, degree, alpha,
              mask):
    """(distance evaluations, distinct candidate rows) that one α-scan of
    these inputs needs, given its result ``mask``: an eligible candidate
    (valid, not the node, not yet kept, fewer than ``degree`` kept and at
    least one) tests the kept rows in order up to the first that occludes
    it, all of them if none does."""
    from repro_torch.kernels.gather_dist import gather_dist_ref
    b, l = cand_ids.shape
    m = mask.to(torch.int32)
    before = torch.cumsum(m, 1) - m
    keep = torch.full((b, degree), -1, dtype=torch.int32,
                      device=data.device)
    slots = torch.arange(degree, device=data.device)
    evals = 0
    for j in range(l):
        q, c = cand_ids[:, j], before[:, j]
        occupied = slots[None, :] < c[:, None]
        dup = (occupied & (keep == q[:, None])).any(1)
        eligible = (q >= 0) & (q != node_ids) & (c < degree) & (c > 0) & ~dup
        dr = gather_dist_ref(data[q.clamp_min(0).long()], data, keep)
        occ = occupied & (dr < (alpha * cand_dists[:, j])[:, None])
        first = torch.where(occ.any(1), occ.to(torch.int32).argmax(1) + 1, c)
        evals += int(torch.where(eligible, first, 0).sum())
        slot = c.clamp_max(degree - 1).long()[:, None]
        keep.scatter_(1, slot, torch.where(mask[:, j:j + 1], q[:, None],
                                           keep.gather(1, slot)))
    return evals, int(torch.unique(cand_ids[cand_ids >= 0]).numel())


def mrng_check(torch, args) -> None:
    """``core.nsg.mrng_prune`` on the prune stage's first chunk: one
    alpha_scan launch, bit-equal to ``alpha_prune`` at alpha = 1 and to
    the plain scan (on the card)."""
    from repro_torch.core.build.prune import alpha_prune
    from repro_torch.core.nsg import mrng_prune
    from repro_torch.kernels.alpha_scan import alpha_scan_cuda, \
        alpha_scan_ref
    data, node_ids, cand_ids, cand_dists, degree, _ = args
    before = alpha_scan_cuda.launches
    got = mrng_prune(data, node_ids, cand_ids, cand_dists, degree)
    launched = alpha_scan_cuda.launches - before
    want = alpha_prune(data, node_ids, cand_ids, cand_dists, degree, 1.0)
    plain = alpha_scan_ref(data, node_ids, cand_ids, cand_dists, degree,
                           1.0)[0]
    equal = torch.equal(got, want) and torch.equal(got, plain)
    emit("mrng_prune", b=cand_ids.shape[0], l=cand_ids.shape[1],
         degree=degree, d=data.shape[1], launches=launched,
         equal_to_alpha_prune=equal, kept=int(got.ge(0).sum()))
    if not equal or launched != 1:
        raise AssertionError(f"mrng_prune: {launched} alpha_scan launches, "
                             f"equal to alpha_prune at 1: {equal}")


def alpha_scan_kernel_phase(torch, calls: dict, gpu: str,
                            fit_by_variant: dict) -> dict:
    """alpha_scan at its three path shapes on the operands the fit and the
    tuner gave it (``ScanRecorder``): the first and the last chunk of
    fit_auto's prune stage and of its interconnect, and of the tuner's
    reprune_family pass. Each variant, forced, must give its plain
    version's keep and mask exactly (torch.equal; the plain version runs on
    the card, its distances through gather_dist's kernel). Each variant is
    timed on each first chunk, in turns (warp, staged, staged, warp; ms:
    one event-timed call; device_ms: queued_ms, the median of its two
    turns), beside the plain version; the shape's top-level times are the
    variant ``route`` gives it, which the fits' launches must all have
    taken (``fit_by_variant``: the exact/host fit's, fit_auto's, tune's).
    The bound counts each input once (the distinct candidate rows, D * 4 B
    each, the pools, the node ids, a per-row alpha, the outputs) and the
    distances this data needs (3 D operations each, f32), whatever a
    variant computes."""
    from repro_torch.kernels.alpha_scan import alpha_scan_cuda, \
        alpha_scan_ref
    from repro_torch.kernels.alpha_scan.alpha_scan import VARIANTS, route
    from repro_torch.kernels.gather_dist.gather_dist import vec4_ok

    by_shape, routed_all = {}, set()
    for name, key in SCAN_SHAPES.items():
        if key not in calls:
            raise AssertionError(f"alpha_scan: the {name} scan (L, per-row "
                                 f"alpha = {key}) never ran")
        for args in calls[key]:
            want = alpha_scan_ref(*args)
            for variant in VARIANTS:
                keep, mask = alpha_scan_cuda(*args, variant=variant)
                if not (torch.equal(keep, want[0])
                        and torch.equal(mask, want[1])):
                    raise AssertionError(f"alpha_scan ({variant}) differs "
                                         f"from its plain version at the "
                                         f"{name} shape")
        args = calls[key][0]
        data, node_ids, cand_ids, cand_dists, degree, alpha = args
        b, l = cand_ids.shape
        d = data.shape[1]
        routed = route(degree, l, d, vec4_ok(d, data))
        routed_all.add(routed)
        evals, rows = scan_work(torch, data, node_ids, cand_ids, cand_dists,
                                degree, alpha, alpha_scan_cuda(*args)[1])
        per_row = key[1]
        bmin, by = bound(rows * d * 4 + b * l * 9 + b * 4
                         + (b * 4 if per_row else 0) + b * degree * 4,
                         3 * evals * d, gpu)
        turns = {v: [] for v in VARIANTS}
        ones = {v: [] for v in VARIANTS}
        for variant in VARIANTS + VARIANTS[::-1]:
            run = (lambda v=variant: alpha_scan_cuda(*args, variant=v))
            ones[variant].append(time_ms(run))
            turns[variant].append(queued_ms(torch, run))
        variants = {v: dict(ms=statistics.median(ones[v]),
                            device_ms=statistics.median(turns[v]),
                            device_ms_turns=turns[v],
                            share_of_bound=bmin / statistics.median(
                                turns[v])) for v in VARIANTS}
        plain = time_ms(lambda: alpha_scan_ref(*args), reps=5, warmup=1)
        top = variants[routed]
        by_shape[name] = dict(
            variant=routed, ms=top["ms"], device_ms=top["device_ms"],
            plain_ms=plain, bound_ms=bmin, bound_by=by,
            share_of_bound=top["share_of_bound"], evals=evals,
            distinct_rows=rows, kept=int(alpha_scan_ref(*args)[0].ge(0)
                                         .sum()),
            variants=variants,
            shape=dict(b=b, l=l, degree=degree, d=d, per_row_alpha=per_row))
    for phase, counts in fit_by_variant.items():
        launched = {v for v, c in counts.items() if c > 0}
        if not launched <= routed_all or not launched:
            raise AssertionError(f"alpha_scan: {phase}'s launches took "
                                 f"{counts}, not the routed {routed_all}")
    mrng_check(torch, calls[SCAN_SHAPES["prune"]][0])
    top = by_shape["prune"]
    return dict(route="cuda", source="src/repro_torch/csrc/alpha_scan.cu",
                replaces="src/repro/core/build/prune.py:66",
                max_abs_err=0.0, variant=top["variant"], ms=top["ms"],
                device_ms=top["device_ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                share_of_bound=top["share_of_bound"], library_ms=None,
                variants=top["variants"],
                launches_by_variant_fits=fit_by_variant,
                by_shape=by_shape)


def serve_compacted_phase(torch, index, queries, true_i, backend: str,
                          wrappers: dict) -> None:
    """The compacted search on the exact/host index: ``search(...,
    compact_every=)`` under ``backend`` (rerank 64 for pq and int8) at each
    of COMPACT_SETTINGS, against the uncompacted fused search at the same
    patience. ids, dists, hops, gathered and dup_gathered must be equal,
    wasted_hops no more, and the slices' batch sizes powers of two that
    never grow. QPS: the median of SERVE_RUNS batches of each, in turns;
    launches and host syncs of one search of each."""
    from repro_torch.configs.ann_laion import CONFIG
    k, n = CONFIG.k, queries.shape[0]
    kw = dict(ef=CONFIG.ef_search, dist_backend=backend,
              rerank=CONFIG.rerank, hop_backend="fused")
    for every, patience in COMPACT_SETTINGS:
        def run(c):
            return index.search(queries, k, compact_every=c,
                                patience=patience or 0, **kw)
        d0, i0 = run(0)
        s0 = index.search_stats()
        d1, i1 = run(every)
        s1 = index.search_stats()
        shapes = list(index.last_compaction_shapes)
        times = {0: [], every: []}
        for _ in range(SERVE_RUNS):
            for c in (0, every):
                torch.cuda.synchronize()
                t = time.perf_counter()
                run(c)
                torch.cuda.synchronize()
                times[c].append(time.perf_counter() - t)
        one = per_search(torch, wrappers, lambda: run(every))
        one_plain = per_search(torch, wrappers, lambda: run(0))
        same = (torch.equal(d0, d1) and torch.equal(i0, i1) and all(
            s1[f] == s0[f] for f in ("hops", "gathered", "dup_gathered")))
        emit("serve_compacted", backend=backend, compact_every=every,
             patience=patience, queries=n, runs=SERVE_RUNS,
             qps=n / statistics.median(times[every]),
             qps_min=n / max(times[every]), qps_max=n / min(times[every]),
             qps_uncompacted=n / statistics.median(times[0]),
             qps_uncompacted_min=n / max(times[0]),
             qps_uncompacted_max=n / min(times[0]),
             recall_at_10=recall_at_k(i1.cpu(), true_i.cpu()),
             equal_to_uncompacted=same, stats=s1, stats_uncompacted=s0,
             wasted_hops=s1["wasted_hops"],
             wasted_hops_uncompacted=s0["wasted_hops"], slices=len(shapes),
             shape_log=shapes, per_search=one,
             per_search_uncompacted=one_plain)
        if not same or s1["wasted_hops"] > s0["wasted_hops"]:
            raise AssertionError(f"serve_compacted ({backend}, every "
                                 f"{every}, patience {patience}): results "
                                 f"differ from the uncompacted search")
        if shapes[0] != n or any(b & (b - 1) for b in shapes) or any(
                a < b for a, b in zip(shapes, shapes[1:])):
            raise AssertionError(f"serve_compacted: slice batch sizes "
                                 f"{shapes} are not non-increasing powers "
                                 f"of two from {n}")
        if one["host_syncs"] != len(shapes):
            raise AssertionError(f"serve_compacted: {one['host_syncs']} host "
                                 f"syncs for {len(shapes)} slices")


def host_times(torch, fn, runs: int, warmup: int = 2) -> list:
    """Seconds of each of ``runs`` calls ``fn(i)``, each ended by a device
    sync (request latency as the caller sees it), after ``warmup`` calls."""
    for i in range(warmup):
        fn(i)
    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return times


def plain_user_embed(torch, model, cfg, batch):
    """The user tower with the history bag taken by the plain version of
    embedding_bag on the card (the yardstick of the kernel path)."""
    from repro_torch.kernels.embedding_bag import embedding_bag_ref
    from repro_torch.models.recsys import _l2norm
    from repro_torch.models.recsys_common import table_offsets
    off = table_offsets(cfg.table_vocabs)
    ids = batch["sparse_ids"]
    u = model.table[ids[0][:, 0] + int(off[0])]
    hist = torch.where(ids[1] >= 0, ids[1] + int(off[1]), -1)
    h = embedding_bag_ref(model.table, hist, None, "mean")
    return _l2norm(model.user_tower(torch.cat([u, h], dim=1)))


def recsys_phase(torch, model, cfg, seed: int) -> None:
    """The two-tower model's serve steps at the config's shapes; the
    kernel path against the plain bag on the same requests."""
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data import recsys_batch
    from repro_torch.serve.serve_step import recsys_retrieval_step, \
        recsys_score_step, top_k

    dev = model.table.device
    gen = torch.Generator(device=dev).manual_seed(seed + 303)
    score = recsys_score_step(cfg)
    k = 10
    retrieve = recsys_retrieval_step(cfg, k=k)

    b = RECSYS_SHAPES["serve_p99"].batch
    batches = [recsys_batch(gen, b, cfg) for _ in range(P99_BATCHES)]
    p99_times = sorted(host_times(torch, lambda i: score(model, batches[i]),
                                  P99_BATCHES))
    outs = [score(model, x) for x in batches[:4]]
    ok = all(o.shape == (b,) and bool(torch.isfinite(o).all())
             for o in outs)
    del batches, outs

    bb = RECSYS_SHAPES["serve_bulk"].batch
    bulk = [recsys_batch(gen, bb, cfg) for _ in range(BULK_BATCHES)]
    bulk_times = host_times(torch, lambda i: score(model, bulk[i]),
                            BULK_BATCHES, warmup=1)
    s_bulk = score(model, bulk[0])
    ok &= s_bulk.shape == (bb,) and bool(torch.isfinite(s_bulk).all())
    del bulk, s_bulk

    n_cand = RECSYS_SHAPES["retrieval_cand"].n_candidates
    cands = torch.arange(n_cand, dtype=torch.int32, device=dev)
    users = [recsys_batch(gen, 1, cfg) for _ in range(RETRIEVAL_REQUESTS)]
    ret_times = host_times(torch, lambda i: retrieve(model, users[i], cands),
                           RETRIEVAL_REQUESTS, warmup=1)
    top, ids = retrieve(model, users[0], cands)

    # the same requests again with the plain bag: the same bits
    reqs = recsys_batch(gen, b, cfg)
    got = score(model, reqs)
    with torch.inference_mode():
        sp = reqs["sparse_ids"]
        items = model.item_embed(sp[2][:, 0], sp[3][:, 0])
        want = (plain_user_embed(torch, model, cfg, reqs) * items).sum(1)
        u1 = plain_user_embed(torch, model, cfg, users[0])
        v = model.item_embed(cands, cands % cfg.table_vocabs[3])
        ptop, pidx = top_k((u1 @ v.T)[0], k)
        del v
    scores_equal = torch.equal(got, want)
    top_equal = torch.equal(top, ptop) and torch.equal(ids, cands[pidx])
    distinct = int(torch.unique(ids).numel()) == k
    table = model.table
    emit("recsys", config=cfg.name, table_shape=list(table.shape),
         table_bytes=table.numel() * table.element_size(),
         tower_params=sum(p.numel() for n_, p in model.named_parameters()
                          if n_ != "table"),
         serve_p99=dict(batch=b, runs=P99_BATCHES,
                        median_ms=statistics.median(p99_times) * 1e3,
                        p99_ms=p99_times[math.ceil(0.99 * P99_BATCHES) - 1]
                        * 1e3, max_ms=p99_times[-1] * 1e3),
         serve_bulk=dict(batch=bb, runs=BULK_BATCHES,
                         seconds=statistics.median(bulk_times),
                         qps=bb / statistics.median(bulk_times),
                         qps_min=bb / max(bulk_times)),
         retrieval=dict(candidates=n_cand, k=k, runs=RETRIEVAL_REQUESTS,
                        median_ms=statistics.median(ret_times) * 1e3,
                        max_ms=max(ret_times) * 1e3,
                        top_ids=ids.tolist()),
         plain_bag_requests=b,
         scores_equal_to_plain_bag=scores_equal,
         retrieval_equal_to_plain_bag=top_equal,
         peak_device_bytes=torch.cuda.max_memory_allocated())
    if not ok or not distinct:
        raise AssertionError("recsys: non-finite or mis-shaped scores, or "
                             "repeated retrieval ids")
    if not (scores_equal and top_equal):
        raise AssertionError("recsys: the kernel path differs from the "
                             "plain bag on the card")


def recsys_ann_phase(torch, model, cfg, seed: int) -> None:
    """Retrieval through the tuned index: the item tower's embeddings as
    the database, the user tower's as the queries."""
    from repro_torch.core.flat import FlatIndex
    from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
    from repro_torch.data import recsys_batch

    dev = model.table.device
    gen = torch.Generator(device=dev).manual_seed(seed + 404)
    n, nq, k = RECSYS_ANN_ITEMS, RECSYS_ANN_QUERIES, 10
    items = torch.arange(n, dtype=torch.int32, device=dev) \
        % cfg.table_vocabs[2]
    with torch.inference_mode():
        corpus = model.item_embed(items, items % cfg.table_vocabs[3])
        users = model.user_embed(recsys_batch(gen, nq, cfg))
    corpus, users = corpus.clone(), users.clone()   # plain tensors
    params = IndexParams(pca_dim=cfg.embed_dim, **RECSYS_ANN_PARAMS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    index = TunedGraphIndex(params, device=dev).fit(
        corpus, torch.Generator().manual_seed(seed))
    fit_s = time.perf_counter() - t
    times = host_times(torch, lambda i: index.search(users, k), SERVE_RUNS,
                       warmup=1)
    _, approx = index.search(users, k)
    stats = index.search_stats()
    _, wide = index.search(users, k, ef=256)        # a 4x wider beam
    flat = FlatIndex(corpus)
    flat_times = host_times(torch, lambda i: flat.search(users, k), 3,
                            warmup=1)
    _, exact = flat.search(users, k)
    recall = recall_at_k(approx.cpu(), exact.cpu())
    recall_wide = recall_at_k(wide.cpu(), exact.cpu())
    valid = bool(((approx >= 0) & (approx < n)).all())
    srt = approx.sort(1).values
    distinct = bool((srt[:, 1:] != srt[:, :-1]).all())
    serve_s = statistics.median(times)
    emit("recsys_ann", items=n, cut="2,000,000 items -> 300,000 (the phase "
         "keeps the exact kNN, which grows as N^2)", dim=cfg.embed_dim,
         queries=nq, k=k, params=RECSYS_ANN_PARAMS, fit_seconds=fit_s,
         stage_seconds=index.stage_seconds, runs=SERVE_RUNS,
         qps=nq / serve_s, qps_min=nq / max(times), recall_at_10=recall,
         recall_at_10_ef256=recall_wide, stats=stats,
         brute_force_qps=nq / statistics.median(flat_times),
         ids_valid=valid, ids_distinct=distinct)
    if not (valid and distinct and approx.shape == (nq, k)):
        raise AssertionError("recsys_ann: invalid or repeated ids in a row")


def recsys_cli_phase(src: Path) -> None:
    """``python -m repro_torch.launch.serve --arch <a>`` for each recsys
    arch, as four subprocesses at once: each must exit 0 and print the
    reference's line."""
    import os
    import re
    t = time.perf_counter()
    archs = ("two-tower-retrieval",) + RECSYS_MODELS
    procs = {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", a],
        env={**os.environ, "PYTHONPATH": str(src)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for a in archs}
    failed = []
    for arch, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=RECSYS_CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        line = out.strip()
        ok = proc.returncode == 0 and re.fullmatch(
            re.escape(arch) + r": scored batch 8 \(mean -?\d+\.\d{4}\); "
            r"retrieval top5 ids \[ *\d+( +\d+){4}\]", line) is not None
        emit("recsys_cli", arch=arch, returncode=proc.returncode,
             output=line, seconds=time.perf_counter() - t,
             stderr_tail=err[-2000:] if proc.returncode else "")
        if not ok:
            failed.append(arch)
    if failed:
        raise AssertionError(f"recsys_cli: the serve launcher failed or "
                             f"printed another line for {failed}")


def queued_ms(torch, fn, calls: int = 16) -> float:
    """Device milliseconds per ``fn()`` without the host's launch overhead:
    the calls are enqueued behind a ~20 ms device sleep, so they run back
    to back between the two events (a single event-timed call of a small
    kernel measures mostly the host's time to launch it)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def embedding_bag_kernel_phase(torch, table, cfg, gpu: str,
                               seed: int) -> dict:
    """embedding_bag against its plain version on small tables (f32 and
    bf16, D in {8, 18, 256}, pads and an all-pad bag, both combiners, no,
    integer and float weights), and on a weighted sum whose float64 sum is
    a float32 midpoint short of the exact sum: bit-equal. Then timed at the path's shapes over the full table ``table``,
    cycling 8 id sets against the 50 MB L2, beside the plain version and
    torch's embedding_bag (mode="mean": the path's ids have no pads); at
    each of those shapes the kernel must give the plain version's bits on
    one id set."""
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, \
        embedding_bag_ref
    from repro_torch.models.recsys_common import table_offsets

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 505)
    worst, checks = 0.0, 0
    for d in (8, 18, 256):
        for dtype in (torch.float32, torch.bfloat16):
            small = torch.randn((5000, d), generator=g, device=dev).to(dtype)
            ids = torch.randint(-1, 5000, (300, 32), generator=g, device=dev,
                                dtype=torch.int32)
            ids[0] = -1
            ws = {"none": None,
                  "int": torch.randint(0, 4, (300, 32), generator=g,
                                       device=dev).float(),
                  "float": torch.rand((300, 32), generator=g, device=dev)}
            for combiner in ("sum", "mean"):
                for kind, w in ws.items():
                    got = embedding_bag_cuda(small, ids, w, combiner)
                    want = embedding_bag_ref(small, ids, w, combiner)
                    checks += 1
                    worst = max(worst, float((got - want).abs().max()))
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"embedding_bag differs from its plain version "
                            f"(D={d}, {dtype}, {combiner}, {kind} weights)")
    # 1 + 2^-24 is a float32 midpoint; the exact sum lies 7 * 2^-71 above it
    mid = (torch.tensor([[1.0], [16773185 * 2.0 ** -48]], device=dev),
           torch.tensor([[0, 1]], dtype=torch.int32, device=dev),
           torch.tensor([[1.0, 8390624 * 2.0 ** -23]], device=dev))
    got = embedding_bag_cuda(*mid, "sum")
    checks += 1
    if not (torch.equal(got, embedding_bag_ref(*mid, "sum"))
            and got.view(torch.int32).item() == 0x3F800001):
        raise AssertionError("embedding_bag: the weighted midpoint case "
                             "differs from its plain version or 0x3F800001")
    emit("embedding_bag_checks", checks=checks, max_abs_err=worst)

    off = int(table_offsets(cfg.table_vocabs)[1])
    vocab, bag, d = cfg.table_vocabs[1], cfg.multi_hot[1], table.shape[1]
    shapes = {"serve_p99": RECSYS_SHAPES["serve_p99"].batch,
              "recsys_ann": RECSYS_ANN_QUERIES,
              "serve_bulk": RECSYS_SHAPES["serve_bulk"].batch}
    out = {}
    for name, b in shapes.items():
        sets = Cycle([torch.randint(0, vocab, (b, bag), generator=g,
                                    device=dev, dtype=torch.int32) + off
                      for _ in range(8)])
        longs = Cycle([s_.long() for s_ in sets.items])
        reps, warm = (5, 1) if b > 100_000 else (25, 3)
        ms = time_ms(lambda: embedding_bag_cuda(table, sets.next(), None,
                                                "mean"), reps, warm)
        plain = time_ms(lambda: embedding_bag_ref(table, sets.next(), None,
                                                  "mean"), reps, warm)
        library = time_ms(lambda: torch.nn.functional.embedding_bag(
            longs.next(), table, mode="mean"), reps, warm)
        got = embedding_bag_cuda(table, sets.items[0], None, "mean")
        want = embedding_bag_ref(table, sets.items[0], None, "mean")
        if not torch.equal(got, want):
            raise AssertionError(f"embedding_bag differs from its plain "
                                 f"version at {name} (B={b})")
        plain_err = float((got - want).abs().max())
        lib_err = float((torch.nn.functional.embedding_bag(
            longs.items[0], table, mode="mean") - got).abs().max())
        del got, want
        dev_ms = queued_ms(torch, lambda: embedding_bag_cuda(
            table, sets.next(), None, "mean"))
        # one id set over and over: its rows stay in L2 where they fit
        warm_ms = queued_ms(torch, lambda: embedding_bag_cuda(
            table, sets.items[0], None, "mean"))
        lib_dev_ms = queued_ms(torch, lambda: torch.nn.functional
                               .embedding_bag(longs.next(), table,
                                              mode="mean"))
        uniq = sum(int(torch.unique(s_).numel()) for s_ in sets.items) / 8
        bmin, by = bound(uniq * d * 4 + b * bag * 4 + b * d * 4,
                         2 * b * bag * d, gpu)
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bmin, bound_by=by,
                         plain_max_abs_err=plain_err, library_ms=library,
                         library_max_abs_err=lib_err,
                         device_ms=dev_ms, library_device_ms=lib_dev_ms,
                         device_ms_l2_warm=warm_ms,
                         unique_rows=uniq, rows_read=b * bag,
                         shape=dict(b=b, l=bag, d=d))
        del sets, longs
    head = out["serve_p99"]
    return dict(route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
                replaces="src/repro/kernels/embedding_bag/embedding_bag.py:44",
                max_abs_err=worst,
                **{k_: v for k_, v in head.items() if k_ != "shape"},
                shape=head["shape"], by_shape=out)


class BagGradRecorder:
    """Stands in for embedding_bag_backward_cuda inside the embedding_bag
    op while installed, passing every call through and keeping a copy of
    the first call's operands (the check below reruns the kernel and its
    plain version on them)."""

    def __init__(self, ops):
        self.ops, self.real, self.first = ops, \
            ops.embedding_bag_backward_cuda, None
        ops.embedding_bag_backward_cuda = self

    def __call__(self, grad_out, ids, weights, combiner, out, plan=None,
                 store=False):
        if self.first is None:
            self.first = (grad_out.clone(), ids.clone(),
                          None if weights is None else weights.clone(),
                          combiner)
        return self.real(grad_out, ids, weights, combiner, out, plan, store)

    def close(self):
        self.ops.embedding_bag_backward_cuda = self.real


def table_checksum(torch, model) -> float:
    """The table's sum in float64: it moves if any row moves."""
    return float(model.table.detach().sum(dtype=torch.float64))


def train_run(torch, model, cfg, batch: int, seed: int,
              wrappers: dict) -> dict:
    """TRAIN_STEPS steps of make_train_step(loss_fn_for("recsys", cfg),
    mixed_optimizer(1e-3)) (launch.train's optimizer; a plain take for the
    lookups) at ``batch`` rows, each batch from recsys_batch: per step the
    loss, ms (host clock around the step, synchronized), peak device bytes
    and each wrapper's launches; then one more step under torch.profiler
    (device-busy ms and share, the kernels that took the most time);
    whether every parameter moved."""
    from repro_torch.data import recsys_batch
    from repro_torch.optim import mixed_optimizer
    from repro_torch.train.train_step import loss_fn_for, make_train_step

    opt = mixed_optimizer(1e-3)
    step = make_train_step(loss_fn_for("recsys", cfg), opt)
    state = opt.init(model)
    dense0 = {n: p.detach().clone() for n, p in model.named_parameters()
              if n != "table"}
    sum0 = table_checksum(torch, model)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    losses, ms, peak, per_step = [], [], [], []
    for _ in range(TRAIN_STEPS):
        b = recsys_batch(gen, batch, cfg)
        before = {n: w.launches for n, w in wrappers.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model, state, m = step(model, state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        peak.append(torch.cuda.max_memory_allocated())
        losses.append(float(m["loss"]))
        per_step.append({n: w.launches - before[n]
                         for n, w in wrappers.items()
                         if w.launches != before[n]})
        del b, m
    b = recsys_batch(gen, batch, cfg)             # one more, profiled
    prof = profile_busy(torch, lambda: step(model, state, b))
    del b
    moved = {n: not torch.equal(p.detach(), dense0[n])
             for n, p in model.named_parameters() if n != "table"}
    moved["table"] = table_checksum(torch, model) != sum0
    del state, dense0
    torch.cuda.empty_cache()
    return dict(batch=batch, steps=TRAIN_STEPS, losses=losses, step_ms=ms,
                median_step_ms=statistics.median(ms),
                peak_device_bytes=peak, launches_per_step=per_step,
                profiled_step=prof, device_busy_share=None
                if prof["device_busy_ms"] is None
                else prof["device_busy_ms"] / prof["profiled_wall_ms"],
                params_moved=all(moved.values()),
                not_moved=[n for n, v in moved.items() if not v])


def check_train_run(name: str, run: dict) -> None:
    bad = []
    if not all(math.isfinite(x) for x in run["losses"]):
        bad.append(f"non-finite loss {run['losses']}")
    if not run["params_moved"]:
        bad.append(f"parameters that did not move: {run['not_moved']}")
    if bad:
        raise AssertionError(f"train {name}: " + "; ".join(bad))


def train_phase(torch, model, cfg, gpu: str, seed: int, wrappers: dict):
    """The two-tower model at its full config (``model``: the serving
    phases' 14.35 GB table) trained for TRAIN_STEPS steps at B =
    RECSYS_SHAPES["train_batch"], each step through embedding_bag's
    forward and backward kernels and one grouping (one launch of each,
    asserted), and one profiled step; its launch counts are zeroed just
    before the steps and read just after (TRAIN_STEPS + 1 of each).
    Then, on the first step's operands (g, the history ids, mean): the
    grouping, exact against its plain version (grouping_check); the
    backward kernel into a zero (V, D) gradient with the plan built inside
    the call (add mode) and over the prepared plan (store mode), each
    bit-equal to its plain version on the card; the sum over the prepared
    plan and the two together timed beside the plain version and torch's
    embedding_bag backward (its own dense gradient included). Returns
    (launches, the backward kernel's entry, the grouping's entry)."""
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag import embedding_bag_backward_cuda, \
        embedding_bag_backward_ref, ops as bag_ops

    batch = RECSYS_SHAPES["train_batch"].batch
    recorder = BagGradRecorder(bag_ops)
    torch.cuda.synchronize()
    zero_counts(wrappers)
    try:
        run = train_run(torch, model, cfg, batch, seed + 606, wrappers)
    finally:
        recorder.close()
    launches = {name: w.launches for name, w in wrappers.items()}
    emit("train", arch="two-tower-retrieval", config=cfg.name,
         table_shape=list(model.table.shape), **run)
    check_train_run("two-tower-retrieval", run)
    one_each = all(s.get("embedding_bag") == 1
                   and s.get("embedding_bag_backward") == 1
                   and s.get("bag_grouping") == 1
                   for s in run["launches_per_step"])
    if not one_each:
        raise AssertionError(f"train: a step did not launch each bag kernel "
                             f"and the grouping once: "
                             f"{run['launches_per_step']}")

    g, ids, w, comb = recorder.first
    table = model.table.detach()
    v, d = table.shape
    grouping, plan = grouping_check(torch, ids, v, gpu)
    grouping.update(
        route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="none: the grouping inside XLA's scatter-add transpose of "
                 "src/repro/models/recsys.py:44 (_bag) and "
                 "src/repro/models/dimenet.py:150, :157, :174 "
                 "(jax.ops.segment_sum)",
        shape=dict(b=ids.shape[0], l=ids.shape[1], v=v))
    emit("bag_grouping", **grouping)
    rows = torch.unique(ids)
    out = torch.zeros_like(table)
    embedding_bag_backward_cuda(g, ids, w, comb, out)
    want = embedding_bag_backward_ref(g, ids, w, comb, v)
    equal = torch.equal(out, want)
    err = float((out[rows] - want[rows]).abs().max())
    out.zero_()
    embedding_bag_backward_cuda(g, ids, w, comb, out, plan, store=True)
    equal = equal and torch.equal(out, want)
    del want
    lib_t = table.detach().requires_grad_(True)
    lib_out = torch.nn.functional.embedding_bag(ids.long(), lib_t,
                                                mode=comb)
    (lib_grad,) = torch.autograd.grad(lib_out, lib_t, g, retain_graph=True)
    lib_err = float((lib_grad[rows] - out[rows]).abs().max())
    del lib_grad
    def planned():
        return embedding_bag_backward_cuda(g, ids, w, comb, out, plan,
                                           store=True)

    def grouped_inside():
        return embedding_bag_backward_cuda(g, ids, w, comb, out, store=True)
    ms = time_ms(planned, 10, 2)
    dev_ms = queued_ms(torch, planned, calls=8)
    both_ms = time_ms(grouped_inside, 10, 2)
    both_dev_ms = queued_ms(torch, grouped_inside, calls=8)
    zero_ms = time_ms(lambda: out.zero_(), 5, 1)
    del out, plan
    torch.cuda.empty_cache()
    plain = time_ms(lambda: embedding_bag_backward_ref(g, ids, w, comb, v),
                    3, 1)

    def library_call():
        return torch.autograd.grad(lib_out, lib_t, g, retain_graph=True)
    library = time_ms(library_call, 5, 1)
    library_dev = queued_ms(torch, library_call, calls=3)
    del lib_out, lib_t
    torch.cuda.empty_cache()
    uniq = int(rows.numel())
    bmin, by = bound(uniq * d * 4 + g.numel() * 4 + ids.numel() * 4,
                     2 * ids.numel() * d, gpu)
    entry = dict(route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
                 replaces="none: src/repro/models/recsys.py:44 (_bag, a take "
                          "and a masked sum; XLA's scatter-add transpose)",
                 max_abs_err=err, ms=ms, device_ms=dev_ms,
                 with_grouping_ms=both_ms,
                 with_grouping_device_ms=both_dev_ms, plain_ms=plain,
                 bound_ms=bmin, bound_by=by, library_ms=library,
                 library_device_ms=library_dev,
                 library_max_abs_err=lib_err,
                 library_call="torch.autograd.grad of F.embedding_bag "
                              "(mode=mean), its dense (V, D) gradient "
                              "included",
                 zero_fill_ms=zero_ms, unique_rows=uniq,
                 rows_read=ids.numel(), bit_equal_to_plain=equal,
                 shape=dict(b=ids.shape[0], l=ids.shape[1], d=d, v=v))
    emit("embedding_bag_backward", **entry)
    if not equal:
        raise AssertionError(f"embedding_bag's backward kernel differs from "
                             f"its plain version on the first step's "
                             f"operands (max abs err {err})")
    if not grouping["exact"]:
        raise AssertionError("bag_grouping differs from its plain version "
                             "on the first step's ids")
    return launches, entry, grouping


def train_models_phase(torch, seed: int, wrappers: dict) -> dict:
    """SASRec and DIN at their full configs and DLRM with each table
    capped at DLRM_TRAIN_ROW_CAP rows, each from --seed, trained for
    TRAIN_STEPS steps at B = RECSYS_SHAPES["train_batch"] (train_run). No
    kernel of the port lies on their paths: every wrapper's count must
    stay where it was."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.models import recsys

    batch = RECSYS_SHAPES["train_batch"].batch
    out = {}
    for arch in TRAIN_MODELS:
        cfg, cut = get_arch(arch).config, None
        if arch == "dlrm-mlperf":
            full = sum(cfg.table_vocabs)
            cfg = replace(cfg, table_vocabs=tuple(
                min(v, DLRM_TRAIN_ROW_CAP) for v in cfg.table_vocabs))
            cut = (f"each Criteo table capped at {DLRM_TRAIN_ROW_CAP:,} rows: "
                   f"{sum(cfg.table_vocabs):,} of {full:,} rows (the table "
                   f"and its dense gradient must fit one 80 GB card)")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        model = recsys.INIT[arch](torch.Generator(device="cuda").manual_seed(
            seed), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        before = {n: w.launches for n, w in wrappers.items()}
        run = train_run(torch, model, cfg, batch, seed + 707, wrappers)
        launched = {n: w.launches - before[n] for n, w in wrappers.items()
                    if w.launches != before[n]}
        out[arch] = dict(config=cfg.name, cut=cut,
                         table_shape=list(model.table.shape),
                         table_bytes=model.table.numel() * 4,
                         init_seconds=init_s, lookup="plain take", **run)
        emit("train", arch=arch, **out[arch])
        del model
        torch.cuda.empty_cache()
        check_train_run(arch, run)
        if launched:
            raise AssertionError(f"train {arch}: a kernel launched on a path "
                                 f"that has none: {launched}")
    return out


def trainer_phase(torch, seed: int) -> dict:
    """The Trainer with checkpoints on SASRec at full config (TRAINER_BATCH
    rows a step, a checkpoint every 2 steps): TRAINER_STEPS[0] steps in one
    run against TRAINER_STEPS[1] steps, a restore from the newest
    checkpoint into a fresh model and the remaining steps; the final
    parameters and the table's accumulator within TRAINER_TOL (the
    lookups' index backward need not add in one order on the card)."""
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys
    from repro_torch.optim import mixed_optimizer
    from repro_torch.train.train_step import loss_fn_for, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch("sasrec").config
    opt = mixed_optimizer(1e-3)
    step = make_train_step(loss_fn_for("recsys", cfg), opt)

    def step_fn(state, b):
        model, o = state
        model, o, m = step(model, o, b)
        return (model, o), m

    def batch_fn(s):
        return recsys_batch(torch.Generator(device="cuda").manual_seed(
            seed + 808 + s), TRAINER_BATCH, cfg)

    def fresh():
        model = recsys.sasrec_init(torch.Generator(device="cuda").manual_seed(
            seed), cfg)
        return model, opt.init(model)

    def trainer(d, total):
        return Trainer(step_fn, batch_fn, TrainerConfig(
            total_steps=total, ckpt_every=2, log_every=1, ckpt_dir=d))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        whole = trainer(d1, TRAINER_STEPS[0])
        final = whole.run(fresh())
        cut = trainer(d2, TRAINER_STEPS[1])
        cut.run(fresh())
        resumed_tr = trainer(d2, TRAINER_STEPS[0])
        state, start = resumed_tr.restore_or_init(fresh())
        resumed = resumed_tr.run(state, start_step=start)
        ckpt_bytes = sum(f.stat().st_size for f in Path(d1).rglob("*")
                         if f.is_file())
        for tr in (whole, cut, resumed_tr):
            tr.ckpt.close()
    pairs = [(n, p.detach(), q.detach()) for (n, p), (_, q) in
             zip(final[0].named_parameters(), resumed[0].named_parameters())]
    pairs.append(("table.acc", final[1]["leaves"]["table"]["acc"],
                  resumed[1]["leaves"]["table"]["acc"]))
    close = all(torch.allclose(a, b, **TRAINER_TOL) for _, a, b in pairs)
    bits = all(torch.equal(a, b) for _, a, b in pairs)
    err = max(float((a - b).abs().max()) for _, a, b in pairs)
    out = dict(arch="sasrec", config=cfg.name, batch=TRAINER_BATCH,
               steps=TRAINER_STEPS[0], interrupted_at=TRAINER_STEPS[1],
               restored_step=start, checkpoint_dir_bytes=ckpt_bytes,
               loss_whole=[h["loss"] for h in whole.history],
               loss_resumed=[h["loss"] for h in cut.history]
               + [h["loss"] for h in resumed_tr.history],
               step_ms=[x * 1e3 for x in whole.step_times],
               close=close, bit_equal=bits, max_abs_err=err,
               seconds=time.perf_counter() - t0, **TRAINER_TOL)
    emit("trainer", **out)
    del final, resumed, state
    torch.cuda.empty_cache()
    if start != TRAINER_STEPS[1] or not close:
        raise AssertionError(f"trainer: the resumed run (restored at step "
                             f"{start}) differs from the whole run (max abs "
                             f"err {err})")
    return out


def train_cli_phase(src: Path) -> None:
    """``python -m repro_torch.launch.train`` for each of TRAIN_CLI_RUNS,
    both processes at once: each must exit 0 and print the reference's
    line with a finite loss for each logged step."""
    import os
    import re
    t = time.perf_counter()
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         *args], env={**os.environ, "PYTHONPATH": str(src)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, args in TRAIN_CLI_RUNS}
    failed = []
    for (arch, args), proc in zip(TRAIN_CLI_RUNS, procs.values()):
        try:
            out, err = proc.communicate(timeout=TRAIN_CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        line = out.strip().splitlines()[-1] if out.strip() else ""
        ok = proc.returncode == 0 and re.fullmatch(
            re.escape(arch) + r": trained 4 steps; history=\[-?\d+\.\d+"
            r"(, -?\d+\.\d+){3}\]", line) is not None
        emit("train_cli", arch=arch, args=args, returncode=proc.returncode,
             output=line, seconds=time.perf_counter() - t,
             stderr_tail=err[-2000:] if proc.returncode else "")
        if not ok:
            failed.append(arch)
    if failed:
        raise AssertionError(f"train_cli: the train launcher failed or "
                             f"printed another line for {failed}")


def cpu_twin(torch, model):
    """The model's weights copied to the CPU, all but its table: a (0, D)
    stand-in there, whose rows a lookup_fn fetches from the card's table
    (a gather, exact). So the CPU runs the model's arithmetic on the same
    weights without a copy of a 45 GB table."""
    import copy
    from torch import nn
    table = model.table
    model.table = None
    try:
        twin = copy.deepcopy(model).cpu()
    finally:
        model.table = table
    twin.table = nn.Parameter(torch.empty((0, table.shape[1])),
                              requires_grad=False)
    return twin, lambda _, ids: table[ids.to(table.device)].cpu()


def rows_of(batch, n: int):
    return {k: [x[:n] for x in v] if isinstance(v, list) else v[:n]
            for k, v in batch.items()}


def recsys_models_phase(torch, seed: int) -> dict:
    """SASRec, DIN and DLRM at their full configs (DLRM's tables capped at
    DLRM_ROW_CAP rows, its lookup row-sharded over a mesh naming cuda:0
    SHARDS times and held equal to a plain take), each from --seed: score
    ms at B = 512 (median and p99 of P99_BATCHES), bulk queries/s at B =
    262,144 (median of BULK_BATCHES), 1 x 1,000,000 retrieval ms (median
    of RETRIEVAL_REQUESTS), table and peak bytes, and the card's scores of
    RECSYS_CPU_ROWS requests and of one user's first 4,096 candidates
    against the same weights on the CPU (cpu_twin), to RECSYS_CPU_TOL.
    Returns each model's summary."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data import recsys_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import recsys
    from repro_torch.models.recsys_common import globalize_ids, \
        make_sharded_lookup, table_offsets
    from repro_torch.serve.serve_step import chunk_rows, \
        recsys_retrieval_step, recsys_score_step

    k, n_check = 10, 4096
    b = RECSYS_SHAPES["serve_p99"].batch
    bb = RECSYS_SHAPES["serve_bulk"].batch
    n_cand = RECSYS_SHAPES["retrieval_cand"].n_candidates
    out = {}
    for arch in RECSYS_MODELS:
        cfg = get_arch(arch).config
        cut = None
        if arch == "dlrm-mlperf":
            full = sum(cfg.table_vocabs)
            cfg = replace(cfg, table_vocabs=tuple(
                min(v, DLRM_ROW_CAP) for v in cfg.table_vocabs))
            cut = (f"each Criteo table capped at {DLRM_ROW_CAP:,} rows: "
                   f"{sum(cfg.table_vocabs):,} of {full:,} rows (the full "
                   f"tables' {full * cfg.embed_dim * 4 / 1e9:.1f} GB exceed "
                   f"the card's 80 GB)")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model = recsys.INIT[arch](torch.Generator(device="cuda").manual_seed(
            seed), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        lookup, lookup_equal = None, None
        if arch == "dlrm-mlperf":
            mesh = make_host_mesh(model=SHARDS, devices=["cuda:0"] * SHARDS)
            lookup = make_sharded_lookup(mesh, model.table.shape[0])
        score = recsys_score_step(cfg, lookup)
        retrieve = recsys_retrieval_step(cfg, k=k, lookup_fn=lookup)
        gen = torch.Generator(device="cuda").manual_seed(seed + 505)
        batches = [recsys_batch(gen, b, cfg) for _ in range(P99_BATCHES)]
        if lookup is not None:
            ids = globalize_ids(batches[0]["sparse_ids"],
                                table_offsets(cfg.table_vocabs)).reshape(-1)
            with torch.inference_mode():     # a serving check: no graph
                lookup_equal = bool(torch.equal(lookup(model.table, ids),
                                                model.table[ids]))
        p99 = sorted(host_times(torch, lambda i: score(model, batches[i]),
                                P99_BATCHES))
        s0 = score(model, batches[0])
        ok = s0.shape == (b,) and bool(torch.isfinite(s0).all())

        # the card against the CPU on the same weights
        twin, cpu_lookup = cpu_twin(torch, model)
        reqs = rows_of(batches[0], RECSYS_CPU_ROWS)
        got = score(model, reqs).cpu()
        cpu_score = recsys_score_step(cfg, cpu_lookup)
        want = cpu_score(twin, {k_: [x.cpu() for x in v]
                                if isinstance(v, list) else v.cpu()
                                for k_, v in reqs.items()})
        user = recsys_batch(gen, 1, cfg)
        cands = torch.arange(n_cand, dtype=torch.int32, device="cuda")
        full_k = recsys_retrieval_step(cfg, k=n_check, lookup_fn=lookup)
        ct, ci = full_k(model, user, cands[:n_check])
        pt, pi = recsys_retrieval_step(cfg, k=n_check, lookup_fn=cpu_lookup)(
            twin, {k_: [x.cpu() for x in v] if isinstance(v, list)
                   else v.cpu() for k_, v in user.items()},
            cands[:n_check].cpu())
        card_by_id = torch.empty(n_check).index_put_((ci.long().cpu(),),
                                                     ct.cpu())
        cpu_by_id = torch.empty(n_check).index_put_((pi.long(),), pt)
        cpu_close = bool(torch.allclose(got, want, **RECSYS_CPU_TOL)
                         and torch.allclose(card_by_id, cpu_by_id,
                                            **RECSYS_CPU_TOL))
        cpu_err = max(float((got - want).abs().max()),
                      float((card_by_id - cpu_by_id).abs().max()))
        del twin, batches

        bulk = [recsys_batch(gen, bb, cfg) for _ in range(BULK_BATCHES)]
        bulk_times = host_times(torch, lambda i: score(model, bulk[i]),
                                BULK_BATCHES, warmup=1)
        sb = score(model, bulk[0])
        ok &= sb.shape == (bb,) and bool(torch.isfinite(sb).all())
        del bulk, sb

        users = [recsys_batch(gen, 1, cfg) for _ in range(RETRIEVAL_REQUESTS)]
        ret_times = host_times(torch, lambda i: retrieve(model, users[i],
                                                         cands),
                               RETRIEVAL_REQUESTS, warmup=1)
        top, ids_top = retrieve(model, users[0], cands)
        ok &= (int(torch.unique(ids_top).numel()) == k
               and bool(torch.isfinite(top).all()))
        torch.cuda.synchronize()
        table = model.table
        out[arch] = dict(
            config=cfg.name, cut=cut, table_shape=list(table.shape),
            table_bytes=table.numel() * table.element_size(),
            dense_params=sum(p.numel() for n_, p in model.named_parameters()
                             if n_ != "table"),
            init_seconds=init_s,
            lookup="row-sharded over cuda:0 x 4" if lookup else "plain take",
            sharded_lookup_equal_to_take=lookup_equal,
            chunk_rows=chunk_rows(cfg),
            serve_p99=dict(batch=b, runs=P99_BATCHES,
                           median_ms=statistics.median(p99) * 1e3,
                           p99_ms=p99[math.ceil(0.99 * P99_BATCHES) - 1]
                           * 1e3, max_ms=p99[-1] * 1e3),
            serve_bulk=dict(batch=bb, runs=BULK_BATCHES,
                            seconds=statistics.median(bulk_times),
                            qps=bb / statistics.median(bulk_times),
                            qps_min=bb / max(bulk_times)),
            retrieval=dict(candidates=n_cand, k=k, runs=RETRIEVAL_REQUESTS,
                           median_ms=statistics.median(ret_times) * 1e3,
                           max_ms=max(ret_times) * 1e3,
                           top_ids=ids_top.tolist()),
            cpu_check=dict(requests=RECSYS_CPU_ROWS, candidates=n_check,
                           close=cpu_close, max_abs_err=cpu_err,
                           sample_card=got[:4].tolist(),
                           sample_cpu=want[:4].tolist(), **RECSYS_CPU_TOL),
            resident_bytes_before=resident,
            peak_device_bytes=torch.cuda.max_memory_allocated() - resident)
        emit("recsys_models", arch=arch, **out[arch])
        del model, table, users, cands, score, retrieve, lookup
        torch.cuda.empty_cache()
        failed = []
        if not ok:
            failed.append("non-finite or mis-shaped scores, or repeated "
                          "retrieval ids")
        if lookup_equal is False:
            failed.append("the row-sharded lookup differs from a plain take")
        if not cpu_close:
            failed.append(f"the card's scores differ from the CPU's "
                          f"(max abs err {cpu_err})")
        if failed:
            raise AssertionError(f"recsys_models {arch}: "
                                 + "; ".join(failed))
    return out


def family_of(spec: str) -> str:
    """The factory family a spec's head token names."""
    head = spec.split(",")[0]
    for fam in ("IVFPQ", "IVF", "PQ", "HNSW", "NSG", "Flat"):
        if head.startswith(fam):
            return fam
    raise ValueError(spec)


def serve_family(torch, idx, spec: str, params: dict, queries, true_i,
                 wrappers: dict, fit_s: float, extra: dict) -> dict:
    """One factory-built index served: its kernels' launches over one
    search (each family must launch its own), recall@10, QPS (median of
    SERVE_RUNS batches), device-busy share and memory. Returns the
    launches of that search."""
    from repro_torch.core.index_api import SearchParams

    k = 10
    sp = SearchParams(**params)
    idx.search(queries, k, sp)                                   # warm
    one = per_search(torch, wrappers, lambda: idx.search(queries, k, sp))
    times = []
    for _ in range(SERVE_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, i = idx.search(queries, k, sp)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    prof = profile_busy(torch, lambda: idx.search(queries, k, sp))
    serve_s = statistics.median(times)
    recall = recall_at_k(i.cpu(), true_i.cpu())
    busy = prof["device_busy_ms"]
    fam = family_of(spec)
    emit("factory", spec=spec, family=fam, params=params,
         n=idx.ntotal, queries=queries.shape[0], fit_seconds=fit_s,
         recall_at_10=recall, qps=queries.shape[0] / serve_s,
         qps_min=queries.shape[0] / max(times),
         qps_max=queries.shape[0] / min(times), seconds=serve_s,
         memory_bytes=idx.memory_bytes(), per_search=one,
         device_busy_share=None if busy is None else busy / (serve_s * 1e3),
         profile=prof, **extra)
    if not (torch.isfinite(d).all() and i.shape == (queries.shape[0], k)):
        raise AssertionError(f"{spec}: non-finite or mis-shaped results")
    if one["launches"].get(FAMILY_KERNEL[fam], 0) <= 0:
        raise AssertionError(f"{spec}: its search launched no "
                             f"{FAMILY_KERNEL[fam]}: {one}")
    floor = FACTORY_RECALL_FLOOR[spec]
    if recall < floor:
        raise AssertionError(f"{spec}: recall@10 {recall} below {floor}")
    return one["launches"]


def adc_check(torch, idx, queries) -> float:
    """Recall of a PQ or IVF-PQ index's search (every list probed)
    against the exact top-10 over its reconstructions, sum_m
    codebooks[m, code[m]] (plus the row's list centroid for IVF-PQ): the
    ADC distance is the squared distance to that reconstruction, so the
    two rankings agree but for rounding."""
    from repro_torch.core.distances import l2_topk
    from repro_torch.core.index_api import SearchParams
    from repro_torch.core.quant import pq_decode

    if hasattr(idx, "list_codes"):                         # IVF-PQ
        rows = torch.empty((idx.ntotal, idx.dim), device="cuda")
        keep = idx.lists >= 0
        ids = idx.lists[keep].long()
        lists = torch.arange(idx.n_lists, device="cuda")[:, None].expand_as(
            idx.lists)[keep]
        rows[ids] = idx.centroids[lists] + pq_decode(
            idx.list_codes[keep].to(torch.uint8), idx.pq.codebooks)
        params = SearchParams(nprobe=idx.n_lists)
    else:
        rows = pq_decode(idx.codes, idx.codebooks)
        params = None
    _, want = l2_topk(queries, rows, 10)
    _, got = idx.search(queries, 10, params)
    return recall_at_k(got.cpu(), want.cpu())


class FirstCalls:
    """Keeps the operands of the first call of each wrapper in ``names``
    (gather_dist, lut_dist, l2topk) while ``on``: it stands in for the
    wrapper in its ``ops`` module, passes every call on (the wrapper
    launches and counts it) and copies nothing."""

    def __init__(self):
        from repro_torch.kernels.gather_dist import ops as gather_ops
        from repro_torch.kernels.l2topk import ops as l2topk_ops
        from repro_torch.kernels.lut_dist import ops as lut_ops
        self.calls, self.on = {}, ()
        self.slots = {"gather_dist": (gather_ops, "gather_dist_cuda"),
                      "lut_dist": (lut_ops, "lut_dist_cuda"),
                      "l2topk": (l2topk_ops, "l2topk_cuda")}
        self.real = {}
        for name, (mod, attr) in self.slots.items():
            self.real[name] = getattr(mod, attr)
            setattr(mod, attr, self._stand_in(name))

    def _stand_in(self, name):
        def call(*args, **kw):
            if name in self.on and name not in self.calls:
                self.calls[name] = (args, kw)
            return self.real[name](*args, **kw)
        return call

    def restore(self) -> None:
        for name, (mod, attr) in self.slots.items():
            setattr(mod, attr, self.real[name])


def in_slices(fn, operands: tuple, rows: int):
    """``fn(*operands)`` with each operand cut into slices of ``rows``
    along dim 0 and the results concatenated: the plain versions are
    row-independent, and whole they would gather (Q, R, D) rows."""
    import torch
    return torch.cat([fn(*(t[s:s + rows] for t in operands))
                      for s in range(0, operands[0].shape[0], rows)])


def factory_kernel_check(torch, spec: str, calls: dict, wrappers: dict,
                         gpu: str) -> None:
    """Each recorded first call of a family's search (FAMILY_CHECKED)
    again through its wrapper and through its plain version, on the same
    operands: gather_dist within rtol = atol = 1e-5 with the same +inf
    pattern; lut_dist bit-equal (both sum left to right over M); l2topk
    (the centroid probe) dists within rtol = atol = 1e-5 and ids equal on
    >= 99% of rows (l2topk_kernel_phase's rule for float data). The
    wrapper's one-call ms at that shape and its bound are printed beside
    it. The counts are zeroed before the next fit, so these launches
    count nowhere."""
    from repro_torch.kernels.gather_dist import gather_dist_ref
    from repro_torch.kernels.l2topk import l2_topk_ref
    from repro_torch.kernels.l2topk.l2topk import variant_for
    from repro_torch.kernels.lut_dist import lut_dist_ref
    from repro_torch.kernels.lut_dist.lut_dist import route as lut_route

    for name in FAMILY_CHECKED[family_of(spec)]:
        if name not in calls:
            raise AssertionError(f"{spec}: its search made no {name} call")
        args, kw = calls[name]
        real = wrappers[name]
        got = real(*args, **kw)
        if name == "gather_dist":
            q, db, ids = args[:3]           # then norms (None: f32 mode)
            want = in_slices(lambda q_, i_: gather_dist_ref(q_, db, i_),
                             (q, ids), 16)
            fin = torch.isfinite(want)
            if not torch.equal(fin, torch.isfinite(got)):
                raise AssertionError(f"{spec}: gather_dist's +inf pattern "
                                     f"differs from its plain version's")
            err = (got[fin] - want[fin]).abs()
            ok = bool((err <= 1e-5 + 1e-5 * want[fin].abs()).all())
            worst = float(err.max()) if err.numel() else 0.0
            uniq = int(torch.unique(ids[ids >= 0]).numel())
            moved = uniq * q.shape[1] * 4 + q.numel() * 4 + ids.numel() * 8
            ops = 3 * int(fin.sum()) * q.shape[1]
            shape = dict(q=q.shape[0], r=ids.shape[1], d=q.shape[1],
                         n=db.shape[0], padded=int((ids < 0).sum()))
        elif name == "lut_dist":
            lut, codes, ids = args
            want = in_slices(lambda l_, i_: lut_dist_ref(l_, codes, i_),
                             (lut, ids), 256)
            ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
            fin = torch.isfinite(want)
            worst = float((got[fin] - want[fin]).abs().max())
            m = lut.shape[1]
            moved = lut.numel() * 4 + ids.numel() * 8 + \
                int(torch.unique(ids[ids >= 0]).numel()) * m
            ops = int(fin.sum()) * m
            shape = dict(q=lut.shape[0], r=ids.shape[1], m=m,
                         c=lut.shape[2], n=codes.shape[0],
                         padded=int((ids < 0).sum()),
                         variant=lut_route(ids.numel(), kw.get("variant")))
        else:
            q, x, k = args
            gd, gi = got
            wd, wi = l2_topk_ref(q, x, k)
            err = (gd - wd).abs()
            rows = float((gi == wi).all(1).float().mean())
            ok = bool((err <= 1e-5 + 1e-5 * wd.abs()).all()) and rows >= 0.99
            worst = float(err.max())
            moved = (q.shape[0] + x.shape[0]) * q.shape[1] * 4 + \
                q.shape[0] * k * 8
            ops = 2 * q.shape[0] * x.shape[0] * q.shape[1]
            shape = dict(q=q.shape[0], n=x.shape[0], d=q.shape[1], k=k,
                         rows_equal=rows,
                         variant=variant_for(q.shape[0], x.shape[0],
                                             q.shape[1], k))
        ms = time_ms(lambda: real(*args, **kw), 5, 1)
        bmin, by = bound(moved, ops, gpu)
        emit("factory_kernel_check", spec=spec, kernel=name, shape=shape,
             equal=ok, max_abs_err=worst, ms=ms, bound_ms=bmin, bound_by=by)
        if not ok:
            raise AssertionError(f"{spec}: {name} differs from its plain "
                                 f"version on the search's operands")


def factory_phase(torch, data, queries, true_i, wrappers: dict,
                  seed: int, gpu: str) -> dict:
    """The paper's Fig. 1 on the card: each FACTORY_SPECS spec built with
    build_index on the ann-laion data (HNSW on its first HNSW_CUT rows)
    and served; the first call of each FAMILY_CHECKED kernel in a family's
    search held against its plain version (factory_kernel_check). Returns
    each kernel's launches over the phase (every fit and one search per
    family); the counts are zeroed just before each fit and read just
    after each index's one counted search."""
    from repro_torch.core.distances import l2_topk
    from repro_torch.core.index_api import build_index

    total = dict.fromkeys(wrappers, 0)

    def add(counts):
        for name, c in counts.items():
            total[name] += c

    def fit(spec, rows):
        torch.cuda.synchronize()
        zero_counts(wrappers)
        t = time.perf_counter()
        idx = build_index(spec, rows, generator=torch.Generator()
                          .manual_seed(seed), device="cuda")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        add({name: w.launches for name, w in wrappers.items()})
        return idx, fit_s

    t0 = time.perf_counter()
    first = FirstCalls()
    try:
        for spec, params in FACTORY_SPECS:
            idx, fit_s = fit(spec, data)
            first.on = FAMILY_CHECKED.get(family_of(spec), ())
            add(serve_family(torch, idx, spec, params, queries, true_i,
                             wrappers, fit_s, {}))
            first.on = ()
            if first.calls:
                factory_kernel_check(torch, spec, first.calls, wrappers, gpu)
                first.calls.clear()
            if family_of(spec) in ("PQ", "IVFPQ"):
                agree = adc_check(torch, idx, queries)
                emit("factory_adc_check", spec=spec,
                     recall_vs_reconstruction=agree)
                if agree < ADC_CHECK_FLOOR:
                    raise AssertionError(f"{spec}: the ADC top-10 agrees with "
                                         f"the reconstructions' on {agree} "
                                         f"only")
            del idx
            torch.cuda.empty_cache()
    finally:
        first.restore()
    rows = data[:HNSW_CUT]
    _, cut_true = l2_topk(queries, rows, 10)
    idx, fit_s = fit(HNSW_SPEC, rows)
    add(serve_family(torch, idx, HNSW_SPEC, HNSW_PARAMS, queries, cut_true,
                     wrappers, fit_s,
                     {"cut": {"n": HNSW_CUT, "of": data.shape[0],
                              "why": "the host build, fixed so that runs "
                                     "compare"},
                      "layers": len(idx.layers)}))
    del idx
    torch.cuda.empty_cache()
    emit("factory_total", seconds=time.perf_counter() - t0, launches=total)
    return total


def snapshot_phase(torch, index, queries, fit_s: float, data) -> None:
    """save_index / load_index at full size: phase 4's exact/host index
    and its pq-quantized copy written to a temporary directory and read
    back on the card (checksums verified, validate_index run); ids and
    distance bits over the queries must equal the in-memory index's. Then
    a stepped directory whose newest step has a flipped byte must load
    the step before it."""
    import copy
    import os
    import tempfile
    import warnings
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.index_api import build_index
    from repro_torch.core.persist import load_index, save_index
    from repro_torch.serve.faults import corrupt_payload

    f32 = copy.copy(index)
    f32.codec = f32.codes = f32.codec_backend = None
    k, ef = CONFIG.k, CONFIG.ef_search
    cases = (("f32", f32, dict(ef=ef)),
             ("pq", index, dict(ef=ef, rerank=CONFIG.rerank,
                                dist_backend="pq")))
    with tempfile.TemporaryDirectory() as tmp:
        for label, idx, kw in cases:
            d0, i0 = idx.search(queries, k, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = save_index(idx, os.path.join(tmp, label))
            save_s = time.perf_counter() - t
            size = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
            t = time.perf_counter()
            loaded = load_index(path, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            d1, i1 = loaded.search(queries, k, **kw)
            same = bool(torch.equal(i0, i1) and torch.equal(
                d0.view(torch.int32), d1.view(torch.int32)))
            emit("snapshot", index=label, snapshot_bytes=size,
                 save_seconds=save_s, load_and_validate_seconds=load_s,
                 fit_seconds=fit_s, queries=queries.shape[0],
                 bit_identical=same, codec=loaded.codec_backend)
            if not same:
                raise AssertionError(f"snapshot {label}: the loaded index "
                                     f"searches differently")
            del loaded
        spec, n = SNAPSHOT_SMALL
        small = build_index(spec, data[:n], device="cuda")
        root = os.path.join(tmp, "steps")
        save_index(small, root, step=1)
        save_index(small, root, step=2)
        corrupt_payload(os.path.join(root, "step_00000002"), seed=0,
                        n_bytes=1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            back = load_index(root, device="cuda")
        skipped = [str(w.message) for w in caught
                   if "step_00000002" in str(w.message)]
        same = bool(torch.equal(back.search(queries, k)[1],
                                small.search(queries, k)[1]))
        emit("snapshot_fallback", spec=spec, n=n, skipped=skipped,
             equal_to_step_1=same)
        if not skipped or not same:
            raise AssertionError("the stepped load did not fall back past "
                                 "the corrupt newest step")


def serve_cli_phase(src: Path) -> None:
    """The ANN launchers as subprocesses, each line parsed: serve
    --arch ann-laion with its defaults (bucketed, micro-batched), with
    --spec IVF64,Flat --buckets off --snapshot, then --restore from that
    snapshot (which must skip the build and give the same recall), then
    tune --spec. No fault is injected, so a "resilience:" line (failed
    tickets, failed flushes, retries) means a search failed."""
    import os
    import re
    import tempfile

    env = {**os.environ, "PYTHONPATH": str(src)}
    recalls = {}
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snap")
        for name, argv, floor in SERVE_CLI_RUNS:
            argv = [a.replace("{snap}", snap) for a in argv]
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve", *argv],
                env=env, capture_output=True, text=True,
                timeout=SERVE_CLI_TIMEOUT)
            out = proc.stdout
            m = re.search(r"^ann-laion \[([^\]]+)\][^:]*: (\d+) QPS, "
                          r"recall@10=(\d+\.\d+)", out, re.MULTILINE)
            recall = float(m.group(3)) if m else None
            recalls[name] = recall
            restored = re.search(r"^restored \[", out, re.MULTILINE)
            resilience = re.search(r"^\s*resilience: .*$", out, re.MULTILINE)
            emit("serve_cli", run=name, args=argv,
                 returncode=proc.returncode,
                 seconds=time.perf_counter() - t,
                 spec=m.group(1) if m else None,
                 qps=int(m.group(2)) if m else None, recall_at_10=recall,
                 restored=bool(restored), output=out.splitlines(),
                 stderr_tail=proc.stderr[-2000:] if proc.returncode else "")
            if proc.returncode != 0 or recall is None or recall < floor:
                raise AssertionError(f"serve_cli {name}: failed or recall "
                                     f"{recall} below {floor}")
            if resilience:
                raise AssertionError(f"serve_cli {name}: searches failed or "
                                     f"were retried: {resilience.group(0)}")
            if (name == "ivf_restore") != bool(restored) or (
                    name == "ivf_restore" and "snapshot saved" in out):
                raise AssertionError(f"serve_cli {name}: restore line "
                                     f"missing or misplaced")
    if recalls["ivf_restore"] != recalls["ivf_snapshot"]:
        raise AssertionError(f"the restored index's recall moved: {recalls}")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", *TUNE_SPEC_ARGS],
        env=env, capture_output=True, text=True, timeout=SERVE_CLI_TIMEOUT)
    lines = proc.stdout.splitlines()
    best = re.search(r"\{'nprobe': (\d+)\}\s+(\d+\.\d+)", proc.stdout)
    emit("serve_cli", run="tune_spec", args=TUNE_SPEC_ARGS,
         returncode=proc.returncode, seconds=time.perf_counter() - t,
         best_nprobe=int(best.group(1)) if best else None,
         best_recall_at_10=float(best.group(2)) if best else None,
         output=lines, stderr_tail=proc.stderr[-2000:]
         if proc.returncode else "")
    if proc.returncode != 0 or best is None or not any(
            "6 pure cache hits" in ln for ln in lines):
        raise AssertionError("tune --spec failed or printed no best trial "
                             "and build log")


def timed_search(torch, idx, queries, k: int, ef: int):
    """One warm search, then the median host time of SERVE_RUNS (each to
    the device's completion); returns (dists, ids, seconds, all times)."""
    idx.search(queries, k, ef=ef)                               # warm
    times = []
    for _ in range(SERVE_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, i = idx.search(queries, k, ef=ef)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return d, i, statistics.median(times), times


def bits_equal(torch, a, b) -> bool:
    """Same shape and the same bits (float views as int32)."""
    if a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(torch.equal(a, b))


def shard_neighbors(spmd, streamed, derived=None):
    """Each shard's graph, valid rows only, from both tiers (which pad to
    different row counts): [(mesh block, streamed block), ...]."""
    a = (derived or spmd).arrays.neighbors.blocks
    out = []
    for s in range(spmd.n_shards):
        n_s = int((spmd.arrays.global_ids.blocks[s] >= 0).sum())
        out.append((a[s][:n_s].cpu(),
                    streamed.store.peek_host(s)["neighbors"][:n_s]))
    return out


def sharded_phase(torch, data, queries, true_i, wrappers: dict, seed: int,
                  gpu: str) -> dict:
    """ROADMAP item 9 at full width: ShardedIndex over a 4 x cuda:0 mesh
    and StreamedShardedIndex (4 shards of 75k), each fit with the
    ann-laion config's IndexParams as fit_auto uses them, must give the
    same searches and reprunes bit for bit; recall@10, fit seconds per
    shard, QPS (median of SERVE_RUNS), each kernel's launches per search
    and per reprune; one shard's search again on the CPU; the sharded
    brute force against FlatIndex; PQ16 row-sharded (the LUT kernel);
    the degraded Flat search with shard 0 dead. Returns the kernels'
    launches over the phase, and the two tiers (sharded_toggles searches
    them again)."""
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.distributed import (
        ShardedFactoryIndex, ShardedIndex, StreamedShardedIndex,
        _local_beam, make_sharded_l2_topk, shard_bounds,
    )
    from repro_torch.core.flat import FlatIndex
    from repro_torch.core.pipeline import IndexParams, structural_build_count
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.faults import FaultInjector

    k, ef, s = CONFIG.k, CONFIG.ef_search, SHARDS
    n, nq = data.shape[0], queries.shape[0]
    params = IndexParams.from_config(CONFIG)
    mesh = make_host_mesh(model=s, devices=["cuda:0"] * s)
    torch.cuda.synchronize()
    zero_counts(wrappers)
    t0 = time.perf_counter()
    builds = structural_build_count()
    t = time.perf_counter()
    spmd = ShardedIndex(params, mesh).fit(
        data, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    spmd_fit_s = time.perf_counter() - t
    t = time.perf_counter()
    streamed = StreamedShardedIndex(params, s, device="cuda").fit(
        data, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    streamed_fit_s = time.perf_counter() - t
    fit_launches = {name: w.launches for name, w in wrappers.items()}
    refit_equal = all(torch.equal(a, b)
                      for a, b in shard_neighbors(spmd, streamed))

    d_a, i_a, s_a, t_a = timed_search(torch, spmd, queries, k, ef)
    d_b, i_b, s_b, t_b = timed_search(torch, streamed, queries, k, ef)
    search_equal = bits_equal(torch, d_a, d_b) and bits_equal(torch, i_a,
                                                               i_b)
    one_a = per_search(torch, wrappers, lambda: spmd.search(queries, k,
                                                            ef=ef))
    one_b = per_search(torch, wrappers, lambda: streamed.search(queries, k,
                                                           ef=ef))
    der = {}
    rep = {}
    for name, idx in (("mesh", spmd), ("streamed", streamed)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        box = {}
        rep[name] = per_search(torch, wrappers, lambda: box.setdefault(
            "d", idx.reprune(alpha=REPRUNE[0], degree=REPRUNE[1])))
        rep[name]["seconds"] = time.perf_counter() - t
        der[name] = box["d"]
    pairs_r = shard_neighbors(spmd, der["streamed"], der["mesh"])
    reprune_equal = all(torch.equal(a, b) for a, b in pairs_r)
    dr_a, ir_a, sr_a, _ = timed_search(torch, der["mesh"], queries, k, ef)
    dr_b, ir_b, sr_b, _ = timed_search(torch, der["streamed"], queries, k,
                                       ef)
    reprune_search_equal = bits_equal(torch, dr_a, dr_b) and bits_equal(
        torch, ir_a, ir_b)
    if structural_build_count() - builds != 2 * s:
        raise AssertionError("a reprune rebuilt a shard")
    recall = recall_at_k(i_a.cpu(), true_i.cpu())
    recall_r = recall_at_k(ir_a.cpu(), true_i.cpu())

    # one shard's search again on the CPU, where the plain versions run
    nr = min(REF_QUERIES, nq)
    q_proj = (queries[:nr] - spmd.arrays.pca_mean) @ spmd.arrays.pca_comp
    fields_ = ("base", "neighbors", "global_ids", "centroids", "members")
    blocks = [getattr(spmd.arrays, f).blocks[0] for f in fields_]
    d_g, i_g = _local_beam(q_proj, *blocks, ef=ef, k=k, max_iters=0,
                           mode="while")
    d_c, i_c = _local_beam(q_proj.cpu(), *(b.cpu() for b in blocks), ef=ef,
                           k=k, max_iters=0, mode="while")
    # the CPU's hop scores by the dot formula (the reference's default),
    # the card's fused hop by gather_dist's diff-square form: they differ
    # by rounding relative to |q|^2 + |x|^2, the scale of the atol
    scale = float((q_proj * q_proj).sum(1).max()
                  + (blocks[0] * blocks[0]).sum(1).max())
    cpu_rows = float((i_c == i_g.cpu()).all(1).float().mean())
    cpu_close = torch.allclose(d_c, d_g.cpu(), rtol=1e-5,
                               atol=1e-6 * scale)

    # the sharded brute force against FlatIndex over the whole base
    bounds = shard_bounds(n, s)
    brute = make_sharded_l2_topk(mesh, k)
    bd, bi = brute(queries, data, bounds[:-1])
    fd, fi = FlatIndex(data).search(queries, k)
    brute_equal = bits_equal(torch, bd, fd) and bits_equal(torch, bi, fi)

    # PQ16 row-sharded on the first PQ_CUT rows: the LUT kernel
    pq_rows = data[:PQ_CUT]
    _, pq_true = FlatIndex(pq_rows).search(queries, k)
    before = {name: w.launches for name, w in wrappers.items()}
    t = time.perf_counter()
    pq = ShardedFactoryIndex("PQ16", s, device="cuda").fit(
        pq_rows, generator=torch.Generator().manual_seed(seed))
    _, pq_i = pq.search(queries, k)
    torch.cuda.synchronize()
    pq_s = time.perf_counter() - t
    pq_launches = {name: w.launches - before[name]
                   for name, w in wrappers.items()
                   if w.launches != before[name]}
    pq_recall = recall_at_k(pq_i.cpu(), pq_true.cpu())
    del pq

    # the degraded search: Flat over 4 shards, shard 0 permanently dead
    flat = ShardedFactoryIndex("Flat", s, on_shard_error="skip",
                               device="cuda").fit(data)
    flat.subs[0] = FaultInjector(permanent_rate=1.0).wrap_index(
        flat.subs[0])
    sd, si = flat.search(queries, k)
    off = int(bounds[1])
    ed, ei = FlatIndex(data[off:]).search(queries, k)
    skip_equal = bits_equal(torch, sd, ed) and bits_equal(
        torch, si, ei + off)
    degraded = flat.degraded_shards
    del flat
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    stats = spmd.shard_stats
    m_a, m_b = spmd._m, streamed._m
    scans = {"mesh": s * -(-m_a // SHARDLOCAL_BLOCK),
             "streamed": s * -(-m_b // SHARDLOCAL_BLOCK)}
    emit("sharded", n=n, shards=s, queries=nq, k=k, ef=ef,
         mesh_devices=[str(d) for d in mesh.devices.flat],
         padded_rows={"mesh": m_a, "streamed": m_b},
         n_kept=spmd.ntotal, fit_seconds={"mesh": spmd_fit_s,
                                          "streamed": streamed_fit_s},
         fit_seconds_per_shard=[st["build_seconds"] for st in stats],
         fit_stage_seconds_per_shard=stats,
         refit_bitwise_equal=refit_equal,
         search_bitwise_equal=search_equal,
         reprune=dict(alpha=REPRUNE[0], degree=REPRUNE[1]),
         reprune_bitwise_equal=reprune_equal,
         reprune_search_bitwise_equal=reprune_search_equal,
         recall_at_10=recall, recall_at_10_reprune=recall_r,
         qps={"mesh": nq / s_a, "streamed": nq / s_b,
              "mesh_reprune": nq / sr_a, "streamed_reprune": nq / sr_b},
         qps_min={"mesh": nq / max(t_a), "streamed": nq / max(t_b)},
         qps_max={"mesh": nq / min(t_a), "streamed": nq / min(t_b)},
         per_search={"mesh": one_a, "streamed": one_b},
         per_reprune=rep, alpha_scan_chunks_expected=scans,
         memory_bytes={"mesh": spmd.memory_bytes(),
                       "streamed": streamed.memory_bytes(),
                       "mesh_reprune": der["mesh"].memory_bytes(),
                       "streamed_reprune": der["streamed"].memory_bytes()},
         cpu_shard0={"queries": nr, "ids_equal_rows": cpu_rows,
                     "dists_close": cpu_close, "norm_scale": scale,
                     "max_abs_err": float((d_c - d_g.cpu()).abs().max())},
         brute_force_equal_to_flat=brute_equal,
         pq16={"n": PQ_CUT, "seconds": pq_s, "recall_at_10": pq_recall,
               "launches": pq_launches},
         skip={"degraded_shards": degraded, "equal_to_survivors": skip_equal},
         fit_launches=fit_launches, launches=launches,
         seconds=time.perf_counter() - t0)
    failed = []
    if not refit_equal:
        failed.append("a shard's refit in the other tier gave another "
                      "graph: the fit is not bitwise reproducible")
    if not search_equal:
        failed.append("the two tiers' searches differ")
    if not (reprune_equal and reprune_search_equal):
        failed.append("the two tiers' reprunes differ")
    for name, one in (("mesh", one_a), ("streamed", one_b)):
        if one["launches"].get("beam_hops") != s or one["host_syncs"] != s:
            failed.append(f"a {name} search took {one}, not {s} beam_hops "
                          f"launches and {s} host syncs")
    for name in rep:
        if rep[name]["launches"].get("alpha_scan") != scans[name]:
            failed.append(f"the {name} reprune launched alpha_scan "
                          f"{rep[name]['launches']}, not {scans[name]}")
    if recall < SHARDED_RECALL_FLOOR or recall_r < SHARDED_REPRUNE_FLOOR:
        failed.append(f"recall@10 {recall} / {recall_r} below "
                      f"{SHARDED_RECALL_FLOOR} / {SHARDED_REPRUNE_FLOOR}")
    if cpu_rows < 0.99 or not cpu_close:
        failed.append("shard 0's search differs on the CPU")
    if not brute_equal:
        failed.append("the sharded brute force differs from FlatIndex")
    if pq_launches.get("lut_dist", 0) <= 0 or pq_recall < PQ_SHARDED_FLOOR:
        failed.append(f"sharded PQ16: {pq_launches}, recall {pq_recall}")
    if degraded != 1 or not skip_equal:
        failed.append("the degraded search is not the survivors' top-k")
    if min(launches[name] for name in SHARDED_KERNELS) <= 0:
        failed.append(f"a kernel of the sharded path never launched: "
                      f"{launches}")
    if failed:
        raise AssertionError("sharded: " + "; ".join(failed))
    return launches, spmd, streamed


def sharded_toggles_phase(torch, data, queries, true_i, wrappers: dict,
                          seed: int, spmd, streamed) -> dict:
    """The tiers of the sharded phase under each mode of the ANN toggles
    (MODE_NAMES). bf16: both tiers fit again under ANN_BF16_BASE (the same
    seed, so the same graphs, rows stored in bf16, norms of the f32 rows);
    prenorm: the f32 tiers searched under ANN_PRENORM; bf16+prenorm: the
    bf16 tiers under ANN_PRENORM. Per mode: the two tiers' searches
    bit-equal, recall@10 against the exact top-10, QPS (median of
    SERVE_RUNS), one search's launches and host syncs, and the launches of
    gather_dist and beam_hops under the mode (by_mode), each above zero.
    Then the bf16 base's bytes (half of f32's) and the bf16 tiers'
    reprunes (bit-equal). Returns the phase's launches and by_mode
    counts."""
    from repro_torch import flags
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.distributed import ShardedIndex, \
        StreamedShardedIndex
    from repro_torch.core.pipeline import IndexParams

    k, ef, s = CONFIG.k, CONFIG.ef_search, SHARDS
    nq = queries.shape[0]
    params = IndexParams.from_config(CONFIG)
    counted = ("gather_dist", "beam_hops")
    torch.cuda.synchronize()
    zero_counts(wrappers)
    t0 = time.perf_counter()
    flags.ANN_BF16_BASE = True
    try:
        t = time.perf_counter()
        mesh16 = ShardedIndex(params, spmd.mesh).fit(
            data, torch.Generator().manual_seed(seed))
        streamed16 = StreamedShardedIndex(params, s, device="cuda").fit(
            data, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
    finally:
        flags.ANN_BF16_BASE = False
    tiers = {"bf16": (mesh16, streamed16, False),
             "prenorm": (spmd, streamed, True),
             "bf16+prenorm": (mesh16, streamed16, True)}
    res, failed = {}, []
    for mode, (a, b, prenorm) in tiers.items():
        flags.ANN_PRENORM = prenorm
        try:
            before = {w: wrappers[w].by_mode[mode] for w in counted}
            d_a, i_a, s_a, t_a = timed_search(torch, a, queries, k, ef)
            d_b, i_b, s_b, t_b = timed_search(torch, b, queries, k, ef)
            by_mode = {w: wrappers[w].by_mode[mode] - before[w]
                       for w in counted}
            one = per_search(torch, wrappers, lambda: a.search(queries, k,
                                                               ef=ef))
        finally:
            flags.ANN_PRENORM = False
        equal = bits_equal(torch, d_a, d_b) and bits_equal(torch, i_a, i_b)
        recall = recall_at_k(i_a.cpu(), true_i.cpu())
        res[mode] = dict(
            bitwise_equal=equal, recall_at_10=recall,
            qps={"mesh": nq / s_a, "streamed": nq / s_b},
            qps_min={"mesh": nq / max(t_a), "streamed": nq / max(t_b)},
            qps_max={"mesh": nq / min(t_a), "streamed": nq / min(t_b)},
            launches_by_mode=by_mode, per_search=one)
        if not equal:
            failed.append(f"{mode}: the two tiers' searches differ")
        if recall < TOGGLE_RECALL_FLOOR[mode]:
            failed.append(f"{mode}: recall@10 {recall} below "
                          f"{TOGGLE_RECALL_FLOOR[mode]}")
        if min(by_mode.values()) <= 0:
            failed.append(f"{mode}: a kernel never launched in the mode: "
                          f"{by_mode}")
        if one["launches"].get("beam_hops") != s or one["host_syncs"] != s:
            failed.append(f"{mode}: a search took {one}")
    base32, base16 = spmd.arrays.base.nbytes, mesh16.arrays.base.nbytes
    if 2 * base16 != base32:
        failed.append(f"the bf16 base holds {base16} B, not half of "
                      f"{base32} B")
    # the bf16 tiers' reprunes: derive_local widens the rows to f32
    der_a = mesh16.reprune(alpha=REPRUNE[0], degree=REPRUNE[1])
    der_b = streamed16.reprune(alpha=REPRUNE[0], degree=REPRUNE[1])
    reprune_equal = all(torch.equal(x, y) for x, y in
                        shard_neighbors(mesh16, der_b, der_a))
    if not reprune_equal:
        failed.append("the bf16 tiers' reprunes differ")
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    by_mode_all = {w: dict(wrappers[w].by_mode) for w in counted}
    emit("sharded_toggles", shards=s, queries=nq, k=k, ef=ef,
         fit_seconds_bf16=fit_s, modes=res,
         base_bytes={"f32": base32, "bf16": base16},
         memory_bytes={"mesh_f32": spmd.memory_bytes(),
                       "mesh_bf16": mesh16.memory_bytes(),
                       "streamed_f32": streamed.memory_bytes(),
                       "streamed_bf16": streamed16.memory_bytes()},
         reprune_bf16_bitwise_equal=reprune_equal,
         launches=launches, launches_by_mode=by_mode_all,
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError("sharded_toggles: " + "; ".join(failed))
    del mesh16, streamed16, der_a, der_b
    torch.cuda.empty_cache()
    return dict(launches, by_mode=by_mode_all)


def streamed_phase(torch, wrappers: dict, seed: int) -> dict:
    """The out-of-core tier at STREAMED_N = 4 shards x 300k (each the
    config's own size): the raw vectors are generated on the card, the
    exact top-10 taken there, then moved to host memory before the fit.
    Fit seconds, QPS, recall@10; the peak device memory of a search next
    to the store's bytes (asserted at most two shards' blocks plus the
    batch's own tensors, and below the store); one shard's host-to-device
    copy next to one shard's search. Then the same fit once more under
    ANN_BF16_BASE: the store's bytes (its base leaves exactly half of
    f32's), one shard's copy beside its search, QPS and recall@10. Returns
    the kernels' launches."""
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.distances import l2_topk
    from repro_torch.core.distributed import StreamedShardedIndex, _local_beam
    from repro_torch.core.pipeline import IndexParams
    from repro_torch.data import clustered_vectors, queries_like

    k, ef, s = CONFIG.k, CONFIG.ef_search, SHARDS
    torch.cuda.synchronize()
    zero_counts(wrappers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    raw = clustered_vectors(gen, STREAMED_N, CONFIG.dim)
    queries = queries_like(gen, raw, STREAMED_QUERIES)
    _, true_i = l2_topk(queries, raw, k)
    host = raw.cpu()
    true_i = true_i.cpu()
    del raw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gen_s = time.perf_counter() - t0
    t = time.perf_counter()
    idx = StreamedShardedIndex(IndexParams.from_config(CONFIG), s,
                               device="cuda").fit(
        host, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    store = idx.store
    shard_bytes = [sum(x.numel() * x.element_size()
                       for x in store.peek_host(i).values())
                   for i in range(s)]
    pinned = all(x.is_pinned() for i in range(s)
                 for x in store.peek_host(i).values())
    d, i, serve_s, times = timed_search(torch, idx, queries, k, ef)
    recall = recall_at_k(i.cpu(), true_i)
    nq = queries.shape[0]

    # one shard's copy (no prefetch: a plain fetch) and one shard's search
    q_proj = (queries - idx.pca_mean) @ idx.pca_comp
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    tree = store.fetch(1)
    ev[1].record()
    _local_beam(q_proj, tree["base"], tree["neighbors"], tree["global_ids"],
                tree["centroids"], tree["members"], ef=ef, k=k, max_iters=0,
                mode="while")
    ev[2].record()
    torch.cuda.synchronize()
    copy_ms, search_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    # the batch's own tensors: one search over that resident shard
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _local_beam(q_proj, tree["base"], tree["neighbors"], tree["global_ids"],
                tree["centroids"], tree["members"], ef=ef, k=k, max_iters=0,
                mode="while")
    torch.cuda.synchronize()
    batch_bytes = torch.cuda.max_memory_allocated() - base
    del tree
    torch.cuda.synchronize()
    # the streamed search's peak: at most two shards' blocks on the card
    merge_bytes = s * nq * k * 8 * 4 + q_proj.numel() * 4 * 2
    del q_proj
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    idx.search(queries, k, ef=ef)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    allowed = 2 * max(shard_bytes) + batch_bytes + merge_bytes
    launches = {name: w.launches for name, w in wrappers.items()}
    emit("streamed", n=STREAMED_N, shards=s, dim=CONFIG.dim,
         pca_dim=CONFIG.pca_dim, queries=nq, k=k, ef=ef,
         generate_and_truth_seconds=gen_s, fit_seconds=fit_s,
         fit_seconds_per_shard=[st["build_seconds"]
                                for st in idx.shard_stats],
         n_kept=idx.ntotal, recall_at_10=recall, qps=nq / serve_s,
         qps_min=nq / max(times), qps_max=nq / min(times),
         search_seconds=serve_s,
         store_bytes=store.nbytes(), shard_bytes=shard_bytes,
         store_pinned=pinned, memory_bytes=idx.memory_bytes(),
         search_peak_device_bytes=peak, batch_bytes=batch_bytes,
         merge_bytes=merge_bytes, peak_allowed_bytes=allowed,
         one_shard={"h2d_copy_ms": copy_ms, "search_ms": search_ms},
         copies_if_serial_ms=s * copy_ms, searches_ms=s * search_ms,
         launches=launches, seconds=time.perf_counter() - t0)
    failed = []
    if not pinned:
        failed.append("the store's host buffers are not pinned")
    if peak > allowed or peak >= store.nbytes():
        failed.append(f"search peak {peak} B over {allowed} B (two shards "
                      f"plus the batch) or the store's {store.nbytes()} B")
    if recall < STREAMED_RECALL_FLOOR:
        failed.append(f"recall@10 {recall} below {STREAMED_RECALL_FLOOR}")
    if not (torch.isfinite(d).all() and i.shape == (nq, k)):
        failed.append("non-finite or mis-shaped results")
    if failed:
        raise AssertionError("streamed: " + "; ".join(failed))
    bf16 = streamed_bf16(torch, host, queries, true_i, store, seed)
    emit("streamed_bf16", n=STREAMED_N, shards=s, queries=nq, **bf16)
    launches = {name: w.launches for name, w in wrappers.items()}
    del idx, store, host
    torch.cuda.empty_cache()
    return launches


def streamed_bf16(torch, host, queries, true_i, store32, seed: int) -> dict:
    """The streamed phase's 1.2M fit again under ANN_BF16_BASE: store
    bytes beside the f32 store's (each shard's base leaf exactly half:
    asserted), fit seconds, QPS (median of SERVE_RUNS), recall@10 (above
    STREAMED_BF16_RECALL_FLOOR), one shard's copy beside its search."""
    from repro_torch import flags
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.distributed import StreamedShardedIndex, _local_beam
    from repro_torch.core.pipeline import IndexParams

    k, ef, s = CONFIG.k, CONFIG.ef_search, SHARDS
    nq = queries.shape[0]
    flags.ANN_BF16_BASE = True
    try:
        t = time.perf_counter()
        idx = StreamedShardedIndex(IndexParams.from_config(CONFIG), s,
                                   device="cuda").fit(
            host, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
    finally:
        flags.ANN_BF16_BASE = False
    store = idx.store
    base = [store.peek_host(i)["base"] for i in range(s)]
    base32 = [store32.peek_host(i)["base"] for i in range(s)]
    half = all(b.dtype == torch.bfloat16 and 2 * b.numel() * 2
               == c.numel() * c.element_size() for b, c in zip(base, base32))
    d, i, serve_s, times = timed_search(torch, idx, queries, k, ef)
    recall = recall_at_k(i.cpu(), true_i)
    q_proj = (queries - idx.pca_mean) @ idx.pca_comp
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    tree = store.fetch(1)
    ev[1].record()
    _local_beam(q_proj, tree["base"], tree["neighbors"], tree["global_ids"],
                tree["centroids"], tree["members"], ef=ef, k=k, max_iters=0,
                mode="while")
    ev[2].record()
    torch.cuda.synchronize()
    res = dict(fit_seconds=fit_s, recall_at_10=recall, qps=nq / serve_s,
               qps_min=nq / max(times), qps_max=nq / min(times),
               store_bytes=store.nbytes(), store_bytes_f32=store32.nbytes(),
               base_bytes=sum(b.numel() * 2 for b in base),
               base_bytes_f32=sum(b.numel() * 4 for b in base32),
               base_half_of_f32=half,
               one_shard={"h2d_copy_ms": ev[0].elapsed_time(ev[1]),
                          "search_ms": ev[1].elapsed_time(ev[2]),
                          "bytes": sum(x.numel() * x.element_size()
                                       for x in tree.values())})
    del tree, idx, store
    torch.cuda.empty_cache()
    failed = []
    if not half:
        failed.append("a shard's bf16 base is not half of its f32 base")
    if recall < STREAMED_BF16_RECALL_FLOOR:
        failed.append(f"recall@10 {recall} below {STREAMED_BF16_RECALL_FLOOR}")
    if not (torch.isfinite(d).all() and i.shape == (nq, k)):
        failed.append("non-finite or mis-shaped results")
    if failed:
        raise AssertionError("streamed_bf16: " + "; ".join(failed))
    return res


def sharded_cli_phase(src: Path) -> None:
    """The launchers' --shards as subprocesses: tune's streamed pipeline
    path at N = 20k x 768, tune --spec NSG16, serve --arch ann-laion with
    --on-shard-error skip. Each must exit 0 and reach its floor; the tune
    runs must print "OK — one per shard", the serve run no resilience:
    and no degraded: line."""
    import os
    import re

    env = {**os.environ, "PYTHONPATH": str(src)}
    for name, module, argv, floor, extra in SHARDED_CLI_RUNS:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", module, *argv],
                              env={**env, **extra}, capture_output=True,
                              text=True, timeout=SERVE_CLI_TIMEOUT)
        out = proc.stdout
        if module.endswith("tune"):
            found = [float(x) for x in re.findall(
                r"^trial \d+ \S+ +build=.* recall=(\d+\.\d+)", out,
                re.MULTILINE)]
            recall = max(found) if found else None
            ok_line = "OK — one per shard" in out
        else:
            m = re.search(r"recall@10=(\d+\.\d+)", out)
            recall = float(m.group(1)) if m else None
            ok_line = not re.search(r"^\s*(resilience|degraded): ", out,
                                    re.MULTILINE)
        emit("sharded_cli", run=name, args=argv, env=extra,
             returncode=proc.returncode,
             seconds=time.perf_counter() - t, recall_at_10=recall,
             ok_line=ok_line, output=out.splitlines()[-12:],
             stderr_tail=proc.stderr[-2000:] if proc.returncode else "")
        if proc.returncode != 0 or recall is None or recall < floor \
                or not ok_line:
            raise AssertionError(f"sharded_cli {name}: rc "
                                 f"{proc.returncode}, recall {recall} "
                                 f"(floor {floor}), line ok {ok_line}")


def recall_at_k(found, truth) -> float:
    hits = sum(len(set(a) & set(b)) for a, b in zip(found.tolist(),
                                                     truth.tolist()))
    return hits / truth.numel()


def lm_bytes_read(model, cfg) -> int:
    """Weight bytes a decode step reads: every layer and the head; an
    untied embedding gives only its B rows (not counted)."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    if not cfg.tie_embeddings:
        total -= model.embed.numel() * model.embed.element_size()
    return total


def lm_linear_flops(cfg, tokens: int) -> float:
    """2 x the non-embedding parameters a token uses x tokens: the
    projections and the FFN, an MoE layer's k routed experts, its shared
    ones and its router (``active_param_count``; all of them for a dense
    model); the norms and rope not counted."""
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return 2.0 * (cfg.active_param_count() - emb) * tokens


def lm_attn_flops(cfg, b: int, pairs: float) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs a row needs, every
    layer and head; MLA's at the 192 width its padded v takes too."""
    return 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * b * pairs


def lm_decode_attn_flops(cfg, b: int, kv: float) -> float:
    """A decode step's attention over ``kv`` cached positions a row: GQA's
    QK^T and PV; MLA's absorbed form scores the latent (r) and rope (rd)
    keys and takes the context in the latent, 2 H (2 r + rd) a position
    (its q / output absorption is in the linear count, as wkv_b's)."""
    if cfg.use_mla:
        return (2.0 * cfg.n_layers * cfg.n_heads * b * kv
                * (2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim))
    return lm_attn_flops(cfg, b, kv)


def lm_check_config(cfg):
    """Check 1's config: an MoE config at capacity factor E / k (a
    group's every pair fits); a dense one as it is."""
    if not cfg.moe:
        return cfg
    return replace(cfg, moe_capacity_factor=cfg.n_routed_experts
                   / cfg.moe_top_k)


def routing_flips(torch, served: list, whole: list) -> dict:
    """(token, MoE layer) pairs whose expert set differs between a
    prefill + decode run (``served``: the prefill's log, then each decode
    step's, layer by layer) and a forward over the whole sequence
    (``whole``), how many were compared, and the token positions with a
    flip in any layer."""
    n_layers = len(whole)
    differ = total = 0
    flipped = None
    for layer, rec in enumerate(whole):
        mine = rec["ids"].sort(-1).values
        theirs = torch.cat([r["ids"] for r in served[layer::n_layers]])
        apart = (mine != theirs.sort(-1).values).any(-1)
        differ += int(apart.sum())
        total += mine.shape[0]
        flipped = apart if flipped is None else flipped | apart
    return dict(differ=differ, compared=total,
                positions=flipped.nonzero()[:, 0].tolist())


def forward_routing(whole: list, s: int, n: int) -> list:
    """The forward's routed ids (``whole``: one (S + n, k) entry per MoE
    layer of a B = 1 sequence) in a prefill of ``s`` tokens then ``n``
    decode steps' call order: each layer's first ``s`` rows, then layer
    by layer each step's row."""
    return ([r["ids"][:s] for r in whole]
            + [r["ids"][s + i:s + i + 1] for i in range(n) for r in whole])


def decode_agreement(got, want) -> dict:
    """Check 1's reading of served logits ``got`` against the forward's
    ``want`` (rows, V): relative RMS, largest difference and the logit
    scale; greedy ids equal up to ties within twice the largest
    difference."""
    diff = (got - want).abs()
    max_diff, scale = float(diff.max()), float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= 2 * max_diff
    same = got.argmax(-1) == want.argmax(-1)
    picked = want.gather(1, got.argmax(-1, keepdim=True))[:, 0]
    ids_ok = bool((same | tie).all()) and bool(
        (top2[:, 0] - picked <= 2 * max_diff).all())
    return dict(rel_rms=float((got - want).norm() / want.norm()),
                max_abs_diff=max_diff, logit_scale=scale,
                ids_equal=int(same.sum()), ties=int(tie.sum()),
                ids_ok=ids_ok)


def moe_expert_bytes(model) -> tuple:
    """(bytes of one routed expert's three matrices, bytes of all routed
    experts) over the model's MoE blocks."""
    one, total = 0, 0
    for blk in model.blocks:
        if blk.moe is not None:
            ws = (blk.moe.w_gate, blk.moe.w_up, blk.moe.w_down)
            total += sum(w.numel() * w.element_size() for w in ws)
            one = sum(w[0].numel() * w.element_size() for w in ws)
    return one, total


def moe_routing_summary(log: list, cfg) -> dict:
    """Per MoE layer of one call: pairs, kept, dropped share, slots, the
    distinct experts routed to and the per-expert pair counts (min, max);
    the totals over the layers."""
    layers = []
    for r in log:
        counts = r["counts"].cpu()
        kept = int(r["kept"])
        layers.append(dict(pairs=r["pairs"], kept=kept,
                           dropped_share=1.0 - kept / r["pairs"],
                           slots=r["slots"],
                           distinct_experts=int((counts > 0).sum()),
                           expert_pairs_min=int(counts.min()),
                           expert_pairs_max=int(counts.max())))
    pairs = sum(x["pairs"] for x in layers)
    kept = sum(x["kept"] for x in layers)
    slots = sum(x["slots"] for x in layers)
    per_slot = 6.0 * cfg.d_model * cfg.moe_d_ff      # gate, up, down
    return dict(layers=len(layers), pairs=pairs, kept=kept,
                dropped_share=1.0 - kept / pairs if pairs else 0.0,
                slots=slots, expert_flop_kept=per_slot * kept,
                expert_flop_computed=per_slot * slots,
                capacity_padding_share=1.0 - kept / slots if slots else 0.0,
                distinct_experts=[x["distinct_experts"] for x in layers],
                first_layer_expert_pairs=log[0]["counts"].cpu().tolist()
                if log else [], by_layer=layers)


def lm_serve_phase(torch, arch: str, gpu: str, seed: int) -> dict:
    """One LM at its full config in bf16 from ``seed``: init, check 1
    (prefill then greedy decode against forward), the prefill_32k and
    decode_32k cells at LM_CUTS (ms, tokens/s, weight and peak bytes,
    bound and share), and at the prefill cell one layer's attention
    beside F.scaled_dot_product_attention (a yardstick the port never
    calls). Returns the phase's summary."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import attention
    from repro_torch.serve.serve_step import lm_decode_step, lm_prefill_step

    spec = get_arch(arch)
    cfg = spec.config
    if arch in LM_LAYERS:
        cfg = replace(cfg, n_layers=LM_LAYERS[arch])
    dev = torch.device("cuda")
    bw, _ = peaks(gpu)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    prefill, decode = lm_prefill_step(cfg), lm_decode_step(cfg)
    out = {"arch": arch, "init_seconds": init_s, "weight_bytes": wbytes,
           "params": sum(p.numel() for p in model.parameters()),
           "layers": cfg.n_layers, "layers_cut_from": spec.config.n_layers,
           "param_count": cfg.param_count(),
           "active_param_count": cfg.active_param_count(),
           "resident_bytes_before": resident,
           "skipped": {name: spec.skip_reason(name) for name in LM_SHAPES
                       if spec.skip_reason(name)}}

    def tokens(b, s):
        return torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                             device=dev, dtype=torch.int32)

    def served(ccfg, prompt, n, feed=None):
        """Prefill ``prompt`` (1, s), then ``n`` decode steps, greedy or
        fed ``feed``'s (1, n) tokens: the n + 1 logit rows, the fed ids."""
        s = prompt.shape[1]
        last, cache = lm_prefill_step(ccfg)(model, prompt, max_len=s + n)
        rows, ids = [last[0]], []
        for i in range(n):
            ids.append(rows[-1].argmax(-1).to(torch.int32).reshape(1)
                       if feed is None else feed[:, i])
            lg, cache = lm_decode_step(ccfg)(
                model, ids[-1], cache, torch.full(
                    (1,), s + i, dtype=torch.int32, device=dev))
            rows.append(lg[0])
        return torch.stack(rows), ids

    with torch.no_grad():
        # check 1: prefill then greedy decode == forward over the sequence;
        # an MoE config's held run has the forward's routing
        s, n = LM_CHECK
        ccfg = lm_check_config(cfg)
        prompt = tokens(1, s)
        with M.routing_log() as served_log:
            got, ids = served(ccfg, prompt, n)
        seq = torch.cat([prompt, torch.stack(ids, 1)], 1)
        with M.routing_log() as whole:
            fwd, _ = T.forward(model, ccfg, seq, remat=False)
        want = fwd[0, s - 1:]
        held = free = decode_agreement(got, want)
        check = dict(prompt=s, tokens=n, **held,
                     limits=(LM_BF16_REL, LM_BF16_MAX))
        if cfg.moe:
            forced = forward_routing(whole, s, n)
            with M.forced_routing(forced), M.routing_log() as log:
                got, _ = served(ccfg, prompt, n, feed=seq[:, s:])
            if len(log) != len(forced) or not all(
                    torch.equal(r["ids"], f) for r, f in zip(log, forced)):
                raise AssertionError(f"{arch}: the forced run did not take "
                                     f"the forward's routing")
            held = decode_agreement(got, want)
            check.update(held, capacity_factor=ccfg.moe_capacity_factor,
                         free_run=dict(free, routing_flips=routing_flips(
                             torch, served_log, whole)))
        out["check_decode"] = check
        del fwd, got, want, whole, served_log
        if not (held["rel_rms"] <= LM_BF16_REL and held["max_abs_diff"]
                <= LM_BF16_MAX * held["logit_scale"] and held["ids_ok"]):
            raise AssertionError(f"{arch}: prefill + decode disagrees with "
                                 f"forward: {check}")

        # prefill_32k at its cut: the last position's logits and the cache
        b, sp = LM_CUTS[arch]["prefill_32k"]
        toks = tokens(b, sp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        holder = {}
        ms = time_ms(lambda: holder.update(r=prefill(model, toks)),
                     reps=1, warmup=0)
        last = holder.pop("r")[0]
        peak = torch.cuda.max_memory_allocated()
        routing = None
        if cfg.moe:
            # the routing from one more call, untimed: the log adds kernels
            with M.routing_log() as log:
                prefill(model, toks)
            routing = moe_routing_summary(log, cfg)
        if not (torch.isfinite(last).all() and last.shape == (
                b, cfg.vocab_size)):
            raise AssertionError(f"{arch}: prefill gave non-finite or "
                                 f"mis-shaped logits")
        del last
        t_lin = (lm_linear_flops(cfg, b * sp)
                 + 2.0 * cfg.d_model * cfg.vocab_size * b) / PEAK_BF16
        t_attn = lm_attn_flops(cfg, b, sp * (sp + 1) / 2) / PEAK_F32
        t_ops, t_bytes = (t_lin + t_attn) * 1e3, wbytes / bw * 1e3
        q = torch.randn((b, sp, cfg.n_heads, cfg.head_dim), generator=g,
                        device=dev).bfloat16()
        kv = [torch.randn((b, sp, cfg.n_kv_heads, cfg.head_dim),
                          generator=g, device=dev).bfloat16()
              for _ in range(2)]
        attn_ms = time_ms(lambda: attention(q, *kv, causal=True), reps=1,
                          warmup=0)
        groups = cfg.n_heads // cfg.n_kv_heads
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(groups, dim=2).transpose(1, 2)
                  for x in kv)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=3, warmup=1)
        del q, kv, qt, kt, vt
        prof = profile_busy(torch, lambda: prefill(model, toks)) \
            if arch in LM_PROFILE_PREFILL else None
        out["prefill_32k"] = dict(
            batch=b, prompt=sp, cut_from=(LM_SHAPES["prefill_32k"]
                                          .global_batch,
                                          LM_SHAPES["prefill_32k"].seq_len),
            ms=ms, tokens_per_s=b * sp / ms * 1e3, peak_bytes=peak,
            bound_ms=max(t_ops, t_bytes), bound_by="operations"
            if t_ops >= t_bytes else "bytes",
            bound_attention_f32_ms=t_attn * 1e3,
            bound_linear_bf16_ms=t_lin * 1e3,
            share=max(t_ops, t_bytes) / ms,
            attention_one_layer_ms=attn_ms, sdpa_library_ms=sdpa_ms,
            routing=routing, profile=prof)

        # decode_32k at its cut: a full cache of random values, greedy steps
        # at its last LM_DECODE_STEPS positions
        b, ctx = LM_CUTS[arch]["decode_32k"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = T.init_cache(cfg, b, ctx, dev)
        cache.a.normal_(generator=g)
        cache.b.normal_(generator=g)
        tok = tokens(b, 1)[:, 0]
        pos0 = ctx - LM_DECODE_STEPS
        lg, cache = decode(model, tok, cache, torch.full(
            (b,), pos0 - 1, dtype=torch.int32, device=dev))        # warm
        times, steps_log = [], []
        for i in range(LM_DECODE_STEPS):
            tok = lg.argmax(-1).to(torch.int32)
            pos = torch.full((b,), pos0 + i, dtype=torch.int32, device=dev)
            holder = {}
            times.append(time_ms(lambda: holder.update(
                r=decode(model, tok, cache, pos)), reps=1, warmup=0))
            if cfg.moe:
                # the step's routing from the same step again, untimed (it
                # rewrites the same cache rows)
                with M.routing_log() as log:
                    decode(model, tok, cache, pos)
                steps_log.append(log)
            lg, cache = holder.pop("r")
        peak = torch.cuda.max_memory_allocated()
        prof = profile_busy(torch, lambda: decode(
            model, lg.argmax(-1).to(torch.int32), cache, torch.full(
                (b,), ctx - 1, dtype=torch.int32, device=dev)))
        if not (torch.isfinite(lg).all() and int(cache.length[0]) == ctx):
            raise AssertionError(f"{arch}: decode gave non-finite logits "
                                 f"or lengths {cache.length.tolist()}")
        kv_valid = ctx - LM_DECODE_STEPS / 2 + 0.5     # mean over the steps
        per_pos = (math.prod(cache.a.shape[3:]) + math.prod(cache.b.shape[3:])
                   ) * cache.a.element_size()        # a layer's, one row's
        kv_bytes = cfg.n_layers * per_pos * b * kv_valid
        weight_read = lm_bytes_read(model, cfg)
        routing = None
        if cfg.moe:
            # only the routed experts a step's ids name are read, once each
            one, every = moe_expert_bytes(model)
            touched = [sum(int((r["counts"] > 0).sum()) for r in log)
                       for log in steps_log]
            weight_read += one * statistics.mean(touched) - every
            routing = dict(experts_touched_per_step=touched,
                           expert_bytes=one,
                           first_step=moe_routing_summary(steps_log[0], cfg))
        t_bytes = (weight_read + kv_bytes) / bw * 1e3
        t_ops = (lm_linear_flops(cfg, b) + 2.0 * cfg.d_model
                 * cfg.vocab_size * b) / PEAK_BF16 * 1e3 \
            + lm_decode_attn_flops(cfg, b, kv_valid) / PEAK_F32 * 1e3
        step_ms = statistics.median(times)
        out["decode_32k"] = dict(
            batch=b, context=ctx, cut_from=(LM_SHAPES["decode_32k"]
                                            .global_batch,
                                            LM_SHAPES["decode_32k"].seq_len),
            steps=LM_DECODE_STEPS, ms_per_step=step_ms,
            ms_per_step_min=min(times), ms_per_step_max=max(times),
            tokens_per_s=b / step_ms * 1e3, cache_bytes=(
                cache.a.numel() + cache.b.numel()) * cache.a.element_size(),
            peak_bytes=peak, weight_bytes_read=weight_read,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes"
            if t_bytes >= t_ops else "operations",
            bound_bytes_ms=t_bytes, bound_operations_ms=t_ops,
            share=max(t_bytes, t_ops) / step_ms, routing=routing,
            profile=prof)
        del cache, lg
    del model
    torch.cuda.empty_cache()
    emit("lm_serve", **out)
    return out


def lm_checks_phase(torch, seed: int) -> dict:
    """Check 2: attention above CHUNK_THRESHOLD (chunked_sdpa) against
    sdpa on the card in float32 at LM_ATTN_CHECK. Check 3: a 2-layer
    qwen2-1.5b at full width and vocabulary in float32, the same weights
    and tokens on the card and on the CPU, logits to LM_CPU_TOL."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import CHUNK_THRESHOLD, attention, sdpa

    dev = torch.device("cuda")
    c = LM_ATTN_CHECK
    if c["s"] < CHUNK_THRESHOLD:
        raise AssertionError("check 2 must run above CHUNK_THRESHOLD")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    q = torch.randn((c["b"], c["s"], c["h"], c["hd"]), generator=g,
                    device=dev)
    k, v = (torch.randn((c["b"], c["s"], c["kv"], c["hd"]), generator=g,
                        device=dev) for _ in range(2))
    with torch.no_grad():
        chunked = attention(q, k, v, causal=True)
        plain = sdpa(q, k, v, causal=True)
    attn_err = float((chunked - plain).abs().max())
    attn_ok = torch.allclose(chunked, plain, **LM_ATTN_TOL)
    del q, k, v, chunked, plain

    cfg = replace(get_arch("qwen2-1.5b").config, n_layers=2,
                  dtype="float32")
    cpu_model = T.init_params(torch.Generator().manual_seed(seed), cfg)
    toks = torch.randint(0, cfg.vocab_size, LM_CPU_TOKENS,
                         generator=torch.Generator().manual_seed(seed + 3),
                         dtype=torch.int32)
    with torch.no_grad():
        want, _ = T.forward(cpu_model, cfg, toks, remat=False)
        card_model = cpu_model.to(dev)
        got, _ = T.forward(card_model, cfg, toks.to(dev), remat=False)
    got = got.cpu()
    cpu_err = float((got - want).abs().max())
    cpu_ok = torch.allclose(got, want, **LM_CPU_TOL)
    del cpu_model, card_model
    torch.cuda.empty_cache()
    out = dict(attention_vs_sdpa=dict(shape=c, max_abs_err=attn_err,
                                      tol=LM_ATTN_TOL, ok=attn_ok),
               card_vs_cpu=dict(layers=2, d_model=cfg.d_model,
                                vocab=cfg.vocab_size, tokens=LM_CPU_TOKENS,
                                max_abs_err=cpu_err,
                                logit_scale=float(want.abs().max()),
                                tol=LM_CPU_TOL, ok=cpu_ok),
               moe_card_vs_cpu=lm_moe_check(torch, seed),
               mla_absorbed_vs_rebuilt=lm_mla_check(torch, seed))
    emit("lm_checks", **out)
    if not (attn_ok and cpu_ok and out["moe_card_vs_cpu"]["ok"]
            and out["mla_absorbed_vs_rebuilt"]["ok"]):
        raise AssertionError(f"lm_checks failed: {out}")
    return out


def lm_moe_check(torch, seed: int) -> dict:
    """Check 4: a 2-layer deepseek-moe-16b (1 dense + 1 MoE) at full width
    and vocabulary in float32, one model on the card and its copy on the
    CPU: logits to LM_CPU_TOL. Then its MoE layer on integer-valued
    inputs with the router rounded to multiples of 1/64, so every logit
    is exact on both: the routed ids and the drop set must be equal, the
    outputs to LM_CPU_TOL."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    cfg = replace(get_arch("deepseek-moe-16b").config, n_layers=2,
                  dtype="float32")
    card = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    toks = torch.randint(0, cfg.vocab_size, LM_CPU_TOKENS,
                         generator=torch.Generator().manual_seed(seed + 3),
                         dtype=torch.int32)
    with torch.no_grad():
        got, aux = T.forward(card, cfg, toks.to(dev), remat=False)
        got, aux = got.cpu(), float(aux)
        cpu = T.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg).cpu()
        want, waux = T.forward(cpu, cfg, toks, remat=False)
    logits_err = float((got - want).abs().max())
    logits_ok = torch.allclose(got, want, **LM_CPU_TOL) and \
        abs(aux - float(waux)) <= 1e-5 * abs(float(waux))

    moe = card.blocks[1].moe
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    b, s_ = LM_MOE_INT_TOKENS
    x = (torch.randint(-4, 5, (cfg.d_model,), generator=g, device=dev)
         + torch.randint(-1, 2, (b, s_, cfg.d_model), generator=g,
                         device=dev)).float()
    with torch.no_grad():
        moe.router.copy_(torch.round(moe.router * 64) / 64)
        xt = x.reshape(-1, cfg.d_model)
        grp, _, cap = M.groups_and_capacity(cfg, b * s_)
        routed = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            m = moe.to(d)
            logits = xt.to(d) @ m.router
            _, idx, _ = M._route(logits, cfg.moe_top_k)
            slot = M.dispatch_slots(idx, grp, cfg.n_routed_experts, cap)
            y, _ = M.moe_apply(m, cfg, x.to(d))
            routed[side] = (logits.cpu(), idx.cpu(), slot.cpu(), y.cpu())
    dropped = routed["cpu"][2] >= cfg.n_routed_experts * grp * cap
    del card, cpu, moe, m
    torch.cuda.empty_cache()
    ids_equal = torch.equal(routed["card"][1], routed["cpu"][1])
    drops_equal = torch.equal(routed["card"][2], routed["cpu"][2])
    y_err = float((routed["card"][3] - routed["cpu"][3]).abs().max())
    y_scale = float(routed["cpu"][3].abs().max())
    y_ok = torch.allclose(routed["card"][3], routed["cpu"][3], rtol=1e-4,
                          atol=LM_MOE_LAYER_ATOL * y_scale)
    return dict(layers=2, d_model=cfg.d_model, vocab=cfg.vocab_size,
                tokens=LM_CPU_TOKENS, max_abs_err=logits_err,
                logit_scale=float(want.abs().max()), aux=aux,
                aux_cpu=float(waux),
                int_tokens=LM_MOE_INT_TOKENS, groups=grp, capacity=cap,
                logits_exact=torch.equal(routed["card"][0],
                                         routed["cpu"][0]),
                ids_equal=ids_equal, slots_equal=drops_equal,
                dropped_pairs=int(dropped.sum()), pairs=dropped.numel(),
                layer_max_abs_err=y_err, layer_scale=y_scale,
                layer_atol_of_scale=LM_MOE_LAYER_ATOL, tol=LM_CPU_TOL,
                ok=bool(logits_ok and ids_equal and drops_equal and y_ok
                        and int(dropped.sum()) > 0))


def lm_mla_check(torch, seed: int) -> dict:
    """Check 5: deepseek-v2's MLA at its published widths in float32 on
    the card: one decode step of the absorbed form against the rebuilding
    one over a random latent cache of LM_MLA_CHECK positions (the output
    to LM_MLA_TOL, the written caches equal)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L

    dev = torch.device("cuda")
    cfg = replace(get_arch("deepseek-v2-236b").config, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    p = L.mla_init(g, cfg)
    b, s_ = LM_MLA_CHECK["b"], LM_MLA_CHECK["s"]
    x = torch.randn((b, 1, cfg.d_model), generator=g, device=dev)
    cc = torch.randn((b, s_, cfg.kv_lora_rank), generator=g, device=dev)
    ckr = torch.randn((b, s_, cfg.qk_rope_head_dim), generator=g,
                      device=dev)
    pos = torch.arange(b, device=dev, dtype=torch.int32) + s_ - b
    outs = []
    with torch.no_grad():
        for fn in (L.mla_decode_absorbed, L.mla_decode):
            cache = (cc.clone(), ckr.clone())
            o, cache = fn(p, cfg, x, pos, cache, pos + 1)
            outs.append((o, cache))
    err = float((outs[0][0] - outs[1][0]).abs().max())
    ok = torch.allclose(outs[0][0], outs[1][0], **LM_MLA_TOL) and \
        torch.equal(outs[0][1][0], outs[1][1][0]) and \
        torch.equal(outs[0][1][1], outs[1][1][1])
    scale = float(outs[1][0].abs().max())
    del p, cc, ckr, outs
    torch.cuda.empty_cache()
    return dict(rows=b, positions=s_, heads=cfg.n_heads,
                latent=cfg.kv_lora_rank, rope=cfg.qk_rope_head_dim,
                max_abs_err=err, scale=scale, tol=LM_MLA_TOL, ok=bool(ok))


def lm_train_phase(torch, seed: int, c: dict) -> dict:
    """One of LM_TRAINS (an arch at full width, cut in depth to
    c["layers"] where it names a cut) trained c["steps"] steps of
    make_train_step(loss_fn_for("lm", cfg), adamw(3e-4)) on train_4k's
    sequences at c's batch cut, then one more step under
    torch.profiler: step ms, tokens/s, peak bytes and the losses. Finite
    losses, and every parameter moved (asserted) but those bf16 rounding
    holds: the weights are bf16 with no float32 master copy, as the
    reference's, so an element w keeps its value under a step smaller than
    half its ulp, at least |w| * 2^-9; an Adam step moves an element by at
    most ~lr (|m / sqrt(v)| <= 1.001 after bias correction at steps 1-3
    with b1 0.9, b2 0.95), so a parameter whose every |w| * 2^-9 exceeds
    2 lr (the unit norm weights) is held."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import loss_fn_for, make_train_step

    full = get_arch(c["arch"]).config
    cfg = replace(full, n_layers=c["layers"]) if c["layers"] else full
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw(c["lr"])
    state = opt.init(model)
    step = make_train_step(loss_fn_for("lm", cfg), opt,
                           microbatches=c["microbatches"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms, auxes = [], [], [], []
    for i in range(c["steps"]):
        batch = lm_batch(torch.Generator(device=dev).manual_seed(seed + i),
                         c["batch"], c["seq"], cfg.vocab_size)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, state, met = step(model, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        auxes.append(float(met["aux"]))
    peak = torch.cuda.max_memory_allocated()
    held = {n for n, w in before.items()
            if float(w.float().abs().min()) * 2.0 ** -9 > 2 * c["lr"]}
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    n_params = len(before)
    ms = statistics.median(times)
    batch = lm_batch(torch.Generator(device=dev).manual_seed(seed + 99),
                     c["batch"], c["seq"], cfg.vocab_size)
    prof = profile_busy(torch, lambda: step(model, state, batch))
    out = dict(arch=c["arch"], layers=cfg.n_layers,
               layers_cut_from=full.n_layers,
               params_count=sum(p.numel() for p in model.parameters()),
               batch=c["batch"], seq=c["seq"],
               microbatches=c["microbatches"],
               cut_from=(LM_SHAPES["train_4k"].global_batch,
                         LM_SHAPES["train_4k"].seq_len),
               step_ms=times, step_ms_median=ms,
               tokens_per_s=c["batch"] * c["seq"] / ms * 1e3,
               peak_bytes=peak, losses=losses, aux_losses=auxes,
               grad_norms=norms,
               params_moved=len(moved), params=n_params,
               params_held_by_bf16=sorted(held)[:4] + (
                   ["..."] if len(held) > 4 else []),
               params_held_count=len(held), profile=prof)
    must_move = set(before) - held
    del model, state, before
    torch.cuda.empty_cache()
    emit("lm_train", **out)
    if not all(math.isfinite(x) for x in losses + norms + auxes) \
            or not must_move <= moved:
        raise AssertionError(f"lm_train: non-finite loss or a parameter "
                             f"that did not move: {out}")
    return out


def logit_errors(torch, got, want) -> dict:
    """Relative RMS and largest |got - want| over the largest |want|."""
    d = (got.float() - want.float())
    scale = float(want.float().abs().max())
    return dict(rel_rms=float(d.pow(2).mean().sqrt()
                              / want.float().pow(2).mean().sqrt()),
                max_err_of_scale=float(d.abs().max()) / scale, scale=scale)


def counted(torch, fn) -> tuple:
    """``fn()`` once under the port's cost counter: (its result, the
    collectives per device: calls by kind and link bytes)."""
    from repro_torch.analysis.op_costs import CostCounter
    with CostCounter() as c:
        out = fn()
    torch.cuda.synchronize()
    dev = c.per_device()
    return out, dict(calls=dict(dev.collective_counts),
                     link_bytes=dev.link_bytes)


def lm_tp_tools(torch, cfg, dev, seed: int) -> tuple:
    """lm_tp's helpers on ``dev``: (tokens(b, s), ids of ``cfg``'s
    vocabulary from one generator seeded ``seed + 7``; timed(fn), its
    result and ms between two synchronisations; mesh_of(shape), a mesh
    naming ``dev`` once per device)."""
    from repro_torch.launch.mesh import make_host_mesh
    g = torch.Generator(device=dev).manual_seed(seed + 7)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                             device=dev, dtype=torch.int32)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def mesh_of(shape):
        return make_host_mesh(*shape, devices=[dev] * math.prod(shape))
    return tokens, timed, mesh_of


def lm_tp_phase(torch, gpu: str, smi: str, seed: int) -> dict:
    """qwen2-1.5b tensor-parallel on meshes of cuda:0 repeated against the
    unsharded port on the same card and weights (phase 16's lm_tp), then
    each of LM_TP_MOE (``lm_tp_moe_run``)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import shard_lm, unshard_lm
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import loss_fn_for, make_train_step

    cfg = get_arch("qwen2-1.5b").config
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    tokens, timed, mesh_of = lm_tp_tools(torch, cfg, dev, seed)

    # serve: prefill, then greedy decode on a cache of LM_TP_DECODE rows
    serve = mesh_of(LM_TP_SERVE)
    sm = shard_lm(model, serve)
    prompt = tokens(*LM_TP_PREFILL)
    out = dict(arch=cfg.name, nvidia_smi=smi, gpu=gpu,
               serve_mesh=LM_TP_SERVE, train_mesh=LM_TP_TRAIN,
               prefill=LM_TP_PREFILL, decode=LM_TP_DECODE,
               decode_steps=LM_TP_DECODE_STEPS, batch=LM_TP_BATCH)
    with torch.no_grad():
        for _ in range(2):          # the second call of each is timed
            want, ms_plain = timed(lambda: T.prefill_states(model, cfg,
                                                            prompt))
            _, ms = timed(lambda: T.prefill_states(sm, cfg, prompt,
                                                   mesh=serve))
        want = T.logits_of(model, want[0][:, -1])
        (x, _), coll = counted(torch, lambda: T.prefill_states(
            sm, cfg, prompt, mesh=serve))
        del x, _
        x, cache = T.prefill_states(sm, cfg, prompt, mesh=serve)
        got = T.logits_of(sm, x[:, -1], serve)
        out["prefill_ms"], out["prefill_plain_ms"] = ms, ms_plain
        out["prefill_collectives"] = coll
        out["prefill_logits"] = logit_errors(torch, got, want)
        out["cache_split"] = "seq" if cfg.n_kv_heads % LM_TP_SERVE[1] \
            else "heads"
        del x, cache, got, want
        b, s = LM_TP_DECODE
        n = s - LM_TP_DECODE_STEPS
        rows = tokens(b, n)
        x, c_plain = T.prefill_states(model, cfg, rows, max_len=s)
        tok = T.logits_of(model, x[:, -1]).argmax(-1).int()
        tok_tp = tok.clone()
        del x
        _, c_tp = T.prefill_states(sm, cfg, rows, max_len=s, mesh=serve)
        errs, ms_tp, ms_pl, same_ids = [], [], [], 0
        for i in range(LM_TP_DECODE_STEPS):
            pos = torch.full((b,), n + i, device=dev, dtype=torch.int32)
            (lp, c_plain), t_pl = timed(lambda: T.decode_step(
                model, cfg, tok, c_plain, pos))
            if i == 0:
                _, coll = counted(torch, lambda: T.decode_step(
                    sm, cfg, tok_tp, c_tp, pos, mesh=serve))
                out["decode_collectives"] = coll
            (lt, c_tp), t_tp = timed(lambda: T.decode_step(
                sm, cfg, tok_tp, c_tp, pos, mesh=serve))
            errs.append(logit_errors(torch, lt, lp))
            ms_pl.append(t_pl)
            ms_tp.append(t_tp)
            tok, tok_tp = lp.argmax(-1).int(), lp.argmax(-1).int()
            same_ids += int(torch.equal(lt.argmax(-1), lp.argmax(-1)))
        out["decode_ms"] = statistics.median(ms_tp)
        out["decode_plain_ms"] = statistics.median(ms_pl)
        out["decode_rel_rms_max"] = max(e["rel_rms"] for e in errs)
        out["decode_max_err_of_scale"] = max(e["max_err_of_scale"]
                                             for e in errs)
        out["decode_steps_same_ids"] = same_ids
        del c_plain, c_tp, lp, lt
    del sm
    torch.cuda.empty_cache()

    # train: one step on the 2 x 2 mesh against the unsharded step
    train = mesh_of(LM_TP_TRAIN)
    plain = copy.deepcopy(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t = tokens(*LM_TP_BATCH)
    batch = {"tokens": t, "labels": torch.roll(t, -1, dims=1)}
    opt = adamw(3e-4)
    step_plain = make_train_step(loss_fn_for("lm", cfg), opt)
    step_tp = make_train_step(loss_fn_for("lm", cfg, mesh=train), opt,
                              mesh=train)
    sm = shard_lm(model, train)
    st_plain, st_tp = opt.init(plain), opt.init(sm)
    _, _, met_plain = step_plain(plain, st_plain, batch)
    _, _, met_tp = step_tp(sm, st_tp, batch)
    after = unshard_lm(sm)
    lr = 3e-4
    held = {n for n, w in before.items()
            if float(w.float().abs().min()) * 2.0 ** -9 > 2 * lr}
    moved = {n for n, p in after.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    finite = all(bool(torch.isfinite(p).all())
                 for p in after.parameters())
    # Adam moves an element by about lr whatever its gradient's size, so
    # a leaf whose gradient is rounding noise (bk: the softmax ignores a
    # shift of every key) may move either way: the largest difference
    # between the two steps, in units of lr
    with torch.no_grad():
        diff = max(float((p.float() - q.float()).abs().max()) / lr
                   for p, q in zip(after.parameters(), plain.parameters()))
    del after
    # a second step of each timed, a third of the sharded one counted
    _, ms_plain = timed(lambda: step_plain(plain, st_plain, batch))
    _, ms = timed(lambda: step_tp(sm, st_tp, batch))
    del plain, st_plain
    _, coll = counted(torch, lambda: step_tp(sm, st_tp, batch))
    loss, loss_plain = float(met_tp["loss"]), float(met_plain["loss"])
    out.update(train_ms=ms, train_plain_ms=ms_plain,
               train_collectives=coll, loss=loss, loss_plain=loss_plain,
               loss_rel_diff=abs(loss - loss_plain) / abs(loss_plain),
               params_moved=len(moved), params=len(before),
               params_held_count=len(held), params_finite=finite,
               param_max_diff_over_lr=diff)
    must_move = set(before) - held
    del sm, st_tp, model, before
    torch.cuda.empty_cache()
    emit("lm_tp", **out)
    pre = out["prefill_logits"]
    if not (pre["rel_rms"] <= LM_BF16_REL
            and pre["max_err_of_scale"] <= LM_BF16_MAX
            and out["decode_rel_rms_max"] <= LM_BF16_REL
            and out["decode_max_err_of_scale"] <= LM_BF16_MAX
            and out["loss_rel_diff"] <= LM_TP_LOSS_RTOL
            and math.isfinite(loss) and finite and must_move <= moved
            and out["cache_split"] == "seq"):
        raise AssertionError(f"lm_tp: the tensor-parallel LM left its "
                             f"limits: {out}")
    for c in LM_TP_MOE:
        emit("lm_tp_cut", arch=c["arch"], layers=c["layers"],
             of_layers=get_arch(c["arch"]).config.n_layers)
    out["moe"] = [lm_tp_moe_run(torch, c, gpu, smi, seed) for c in LM_TP_MOE]
    return out


def same_routing(torch, got: list, want: list) -> bool:
    """Two routing logs of one sequence: the same ids and dropped pairs
    in every MoE call."""
    return len(got) == len(want) and all(
        torch.equal(a["ids"], b["ids"]) and torch.equal(a["dropped"],
                                                        b["dropped"])
        for a, b in zip(got, want))


def lm_tp_moe_run(torch, c: dict, gpu: str, smi: str, seed: int) -> dict:
    """One config of LM_TP_MOE tensor- and expert-parallel on meshes of
    cuda:0 repeated against the unsharded port on the same card and
    weights (phase 16's lm_tp)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import cache_split, shard_lm
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import loss_fn_for, make_train_step

    cfg = replace(get_arch(c["arch"]).config, n_layers=c["layers"])
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    tokens, timed, mesh_of = lm_tp_tools(torch, cfg, dev, seed)

    serve = mesh_of(LM_TP_SERVE)
    sm = shard_lm(model, serve)
    out = dict(arch=cfg.name, layers=cfg.n_layers,
               of_layers=get_arch(c["arch"]).config.n_layers,
               nvidia_smi=smi, gpu=gpu, serve_mesh=LM_TP_SERVE,
               prefill=LM_TP_PREFILL, decode=LM_TP_MOE_DECODE,
               decode_steps=LM_TP_MOE_DECODE_STEPS,
               cache_split=cache_split(cfg, serve))
    prompt = tokens(*LM_TP_PREFILL)
    with torch.no_grad():
        for _ in range(2):          # the second call of each is timed
            want, ms_plain = timed(lambda: T.prefill_states(model, cfg,
                                                            prompt))
            _, ms = timed(lambda: T.prefill_states(sm, cfg, prompt,
                                                   mesh=serve))
        want = T.logits_of(model, want[0][:, -1])
        _, coll = counted(torch, lambda: T.prefill_states(
            sm, cfg, prompt, mesh=serve)[0])
        with M.routing_log() as plain_log:
            T.prefill_states(model, cfg, prompt)
        with M.routing_log() as free_log:
            T.prefill_states(sm, cfg, prompt, mesh=serve)
        with M.forced_routing([r["ids"] for r in plain_log]), \
                M.routing_log() as log:
            x, _ = T.prefill_states(sm, cfg, prompt, mesh=serve)
        got = T.logits_of(sm, x[:, -1], serve)
        out.update(prefill_ms=ms, prefill_plain_ms=ms_plain,
                   prefill_collectives=coll,
                   prefill_logits=logit_errors(torch, got, want),
                   prefill_routing_equal=same_routing(torch, log,
                                                      plain_log),
                   prefill_dropped=sum(int(r["dropped"].sum())
                                       for r in log),
                   prefill_pairs=sum(r["pairs"] for r in log),
                   prefill_free_ids_equal=sum(
                       int((a["ids"] == b["ids"]).all(-1).sum())
                       for a, b in zip(free_log, plain_log)),
                   prefill_tokens=prompt.numel() * len(log))
        del x, got, want, plain_log, free_log, log

        b, s = LM_TP_MOE_DECODE
        n = s - LM_TP_MOE_DECODE_STEPS
        rows = tokens(b, n)
        with M.routing_log() as plain_log:
            x, c_plain = T.prefill_states(model, cfg, rows, max_len=s)
        tok = T.logits_of(model, x[:, -1]).argmax(-1).int()
        del x
        with M.forced_routing([r["ids"] for r in plain_log]):
            _, c_tp = T.prefill_states(sm, cfg, rows, max_len=s, mesh=serve)
        errs, ms_tp, ms_pl, same, drops_ok, dropped = [], [], [], 0, True, 0
        for i in range(LM_TP_MOE_DECODE_STEPS):
            pos = torch.full((b,), n + i, device=dev, dtype=torch.int32)
            with M.routing_log() as plain_log:
                (lp, c_plain), t_pl = timed(lambda: T.decode_step(
                    model, cfg, tok, c_plain, pos))
            if i == 0:
                _, coll = counted(torch, lambda: T.decode_step(
                    sm, cfg, tok, c_tp, pos, mesh=serve)[0])
                out["decode_collectives"] = coll
            with M.forced_routing([r["ids"] for r in plain_log]), \
                    M.routing_log() as log:
                (lt, c_tp), t_tp = timed(lambda: T.decode_step(
                    sm, cfg, tok, c_tp, pos, mesh=serve))
            drops_ok &= same_routing(torch, log, plain_log)
            dropped += sum(int(r["dropped"].sum()) for r in log)
            errs.append(logit_errors(torch, lt, lp))
            ms_pl.append(t_pl)
            ms_tp.append(t_tp)
            same += int(torch.equal(lt.argmax(-1), lp.argmax(-1)))
            tok = lp.argmax(-1).int()
        out.update(decode_ms=statistics.median(ms_tp),
                   decode_plain_ms=statistics.median(ms_pl),
                   decode_rel_rms_max=max(e["rel_rms"] for e in errs),
                   decode_max_err_of_scale=max(e["max_err_of_scale"]
                                               for e in errs),
                   decode_steps_same_ids=same,
                   decode_routing_equal=drops_ok, decode_dropped=dropped)
        del c_plain, c_tp, lp, lt
    del sm
    torch.cuda.empty_cache()

    loss = loss_plain = float("nan")
    finite = True
    if c["train"]:
        train = mesh_of(LM_TP_TRAIN)
        t = tokens(*LM_TP_BATCH)
        batch = {"tokens": t, "labels": torch.roll(t, -1, dims=1)}
        opt = adamw(3e-4)
        plain = copy.deepcopy(model)
        st_plain = opt.init(plain)
        step_plain = make_train_step(loss_fn_for("lm", cfg), opt)
        _, _, met_plain = step_plain(plain, st_plain, batch)
        _, ms_plain = timed(lambda: step_plain(plain, st_plain, batch))
        del plain, st_plain
        torch.cuda.empty_cache()
        sm = shard_lm(model, train)
        st_tp = opt.init(sm)
        step_tp = make_train_step(loss_fn_for("lm", cfg, mesh=train), opt,
                                  mesh=train)
        _, _, met_tp = step_tp(sm, st_tp, batch)
        _, ms = timed(lambda: step_tp(sm, st_tp, batch))
        _, coll = counted(torch, lambda: step_tp(sm, st_tp, batch))
        finite = all(bool(torch.isfinite(p).all()) for p in sm.parameters())
        loss, loss_plain = float(met_tp["loss"]), float(met_plain["loss"])
        out.update(train_mesh=LM_TP_TRAIN, batch=LM_TP_BATCH, train_ms=ms,
                   train_plain_ms=ms_plain, train_collectives=coll,
                   loss=loss, loss_plain=loss_plain,
                   loss_rel_diff=abs(loss - loss_plain) / abs(loss_plain),
                   aux=float(met_tp["aux"]), aux_plain=float(
                       met_plain["aux"]), params_finite=finite)
        del sm, st_tp
    del model
    torch.cuda.empty_cache()
    emit("lm_tp", **out)
    pre = out["prefill_logits"]
    if not (pre["rel_rms"] <= LM_BF16_REL
            and pre["max_err_of_scale"] <= LM_BF16_MAX
            and out["decode_rel_rms_max"] <= LM_BF16_REL
            and out["decode_max_err_of_scale"] <= LM_BF16_MAX
            and out["prefill_routing_equal"] and out["decode_routing_equal"]
            and (not c["train"] or (out["loss_rel_diff"] <= LM_TP_LOSS_RTOL
                                    and math.isfinite(loss) and finite))):
        raise AssertionError(f"lm_tp: {cfg.name} tensor- and expert-"
                             f"parallel left its limits: {out}")
    return out


def lm_cli_phase(src: Path) -> None:
    """LM_CLI_RUNS (launch.serve and launch.train for each of
    LM_CLI_ARCHS, on the card by default), every process at once: each
    must exit 0 and print the reference's line."""
    import os
    import re
    patterns = {"serve": r": prefill\(32\) \+ decode\(16\) for "
                         r"batch 8 in \d+\.\d+s \(\d+\.\d tok/s\)",
                "train": r": trained 2 steps; history=\[\d+\.\d+"
                         r"(, \d+\.\d+)*\]"}
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", module, *args],
                              env={**os.environ, "PYTHONPATH": str(src)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _, module, args in LM_CLI_RUNS]
    failed = []
    for (name, module, args), proc in zip(LM_CLI_RUNS, procs):
        try:
            out, err = proc.communicate(timeout=LM_CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        line = out.strip().splitlines()[-1] if out.strip() else ""
        ok = proc.returncode == 0 and re.fullmatch(
            re.escape(args[1]) + patterns[name], line) is not None
        emit("lm_cli", run=name, args=[module, *args],
             returncode=proc.returncode, output=line,
             seconds=time.perf_counter() - t,
             stderr_tail=err[-2000:] if proc.returncode else "")
        if not ok:
            failed.append(f"{name} {args[1]}")
    if failed:
        raise AssertionError(f"lm_cli: the LM launchers failed or printed "
                             f"another line: {failed}")


def lm_phases(torch, src: Path, gpu: str, seed: int, smi: str) -> dict:
    """lm_serve for each of LM_ARCHS, lm_checks, lm_train for each of
    LM_TRAINS, lm_tp and lm_cli."""
    out = {}
    for arch in LM_ARCHS:
        t = time.perf_counter()
        lm_serve_phase(torch, arch, gpu, seed)
        out[f"lm_serve_{arch}"] = time.perf_counter() - t
    t = time.perf_counter()
    lm_checks_phase(torch, seed)
    out["lm_checks"] = time.perf_counter() - t
    for c in LM_TRAINS:
        t = time.perf_counter()
        lm_train_phase(torch, seed, c)
        out[f"lm_train_{c['arch']}"] = time.perf_counter() - t
    t = time.perf_counter()
    lm_tp_phase(torch, gpu, smi, seed)
    out["lm_tp"] = time.perf_counter() - t
    t = time.perf_counter()
    lm_cli_phase(src)
    out["lm_cli"] = time.perf_counter() - t
    return out


def gnn_batch(cell: str, seed: int) -> dict:
    """The cell's padded graph batch on the host (numpy arrays) from
    ``seed``: minibatch_lg through the fan-out sampler, full_graph_sm
    through make_dimenet_batch with its 1,433 features and node targets,
    molecule as the reference's launch/specs.py:205-209 scales it (the
    cell's graph times n_graphs, graph targets)."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data import graph_sampler as G
    s = GNN_SHAPES[cell]
    if cell == "minibatch_lg":
        return G.sampled_dimenet_batch(seed, s)
    if cell == "molecule":
        return G.make_dimenet_batch(
            seed, n_nodes=s.n_nodes * s.n_graphs,
            n_edges=s.n_edges * s.n_graphs,
            n_triplets=s.n_triplets * s.n_graphs, n_graphs=s.n_graphs)
    return G.make_dimenet_batch(seed, s.n_nodes, s.n_edges, s.n_triplets,
                                d_feat=s.d_feat, node_targets=True)


def gnn_counts(host: dict) -> dict:
    """A host batch's nodes, edges and triplets, padded and real."""
    valid = (host["t_kj"] >= 0) & (host["t_ji"] >= 0)
    return dict(nodes=len(host["node_mask"]),
                nodes_real=int(host["node_mask"].sum()),
                edges=len(host["src"]),
                edges_real=int(host["edge_mask"].sum()),
                triplets=len(host["t_kj"]), triplets_real=int(valid.sum()),
                d_feat=host["x"].shape[1] if "x" in host else 0,
                graphs=len(host["y_graph"]) if "y_graph" in host else 1)


def gnn_step_bytes(host: dict, counts: dict, n_params: int,
                   real: bool) -> float:
    """Bytes a training step must move: the batch's arrays read once
    (only their real rows when ``real``) and, per parameter, the weight
    and its gradient written and read, AdamW's two moments read and
    written and the new weight written (7 float32 words)."""
    total = 0.0
    for key, a in host.items():
        k = GNN_ROW_KIND.get(key, "nodes")
        share = counts[f"{k}_real"] / counts[k] if real and k != "graphs" \
            else 1.0
        total += a.nbytes * share
    return total + 7 * 4 * n_params


def gnn_step_flops(cfg, n: int, e: int, t: int, d_feat: int) -> float:
    """float32 FLOP of one training step over n nodes, e edges and t
    triplets: the forward's products (x @ embed; rbf_proj and msg_init
    over the edges; per block w_kj, rbf_gate, w_src, update and out_node
    over the edges, sbf_proj, the bilinear's outer product and its
    (B H) x H product over the triplets; out_final over the nodes), three
    times (the backward's two products per product), x @ embed twice (x
    takes no gradient)."""
    h, b, r = cfg.d_hidden, cfg.n_bilinear, cfg.n_radial
    sbf = r * cfg.n_spherical
    block = (2 * e * (6 * h * h + r * h)
             + 2 * t * (sbf * b + b * h * h) + t * b * h)
    fwd = (2 * e * (r * h + 4 * h * h) + cfg.n_blocks * block
           + 2 * n * (h * h + h * cfg.d_out))
    return 3.0 * fwd + 2.0 * (2 * n * d_feat * h)


def gnn_step_launches(cfg, host: dict) -> dict:
    """Each GNN kernel's launches in one training step on ``host``'s batch:
    a gather (bag) per src, dst and block's t_kj, and embed[z] on atom
    types; a segment sum (backward kernel) per block's agg and node
    readout, and the graph readout with several graphs; each one's
    gradient the other kernel; one grouping per id array (a plan each for
    src, dst, t_kj and t_ji; z's and the graph ids' inside their one call):
    20 / 20 / 4 at 6 blocks, 22 / 22 / 6 on molecule."""
    z = "x" not in host
    graphs = "y_graph" in host and len(host["y_graph"]) > 1
    per = 3 * cfg.n_blocks + 2 + z + graphs
    return {"embedding_bag": per, "embedding_bag_backward": per,
            "bag_grouping": 4 + z + graphs}


def gnn_train_cell(torch, cfg, graph, d_feat: int, seed: int,
                   wrappers: dict) -> tuple:
    """GNN_STEPS steps of make_train_step(loss_fn_for("gnn", cfg),
    adamw(GNN_LR)) on ``graph`` from weights drawn on the CPU from
    ``seed``. Returns (the run, the trained model, its optimizer state,
    the step, a copy of the initial model)."""
    import copy
    from repro_torch.models import dimenet
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import loss_fn_for, make_train_step

    model = dimenet.init_params(torch.Generator().manual_seed(seed), cfg,
                                d_feat).to("cuda")
    init = copy.deepcopy(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw(GNN_LR)
    state = opt.init(model)
    step = make_train_step(loss_fn_for("gnn", cfg), opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms, per_step = [], [], [], []
    for _ in range(GNN_STEPS):
        c0 = {k: wrappers[k].launches for k in GNN_KERNELS}
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, state, met = step(model, state, graph)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        per_step.append({k: wrappers[k].launches - c0[k]
                         for k in GNN_KERNELS})
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    run = dict(step_ms=times, step_ms_median=statistics.median(times[1:]),
               step_ms_min=min(times[1:]), step_ms_max=max(times[1:]),
               first_step_ms=times[0], losses=losses, grad_norms=norms,
               peak_bytes=torch.cuda.max_memory_allocated(),
               params=len(before), params_moved=len(moved),
               params_count=sum(p.numel() for p in model.parameters()),
               launches_per_step=per_step)
    return run, model, state, step, init


@contextlib.contextmanager
def patched(obj, **attrs):
    """``obj``'s attributes set to ``attrs`` inside the block."""
    kept = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in kept.items():
            setattr(obj, k, v)


def gnn_loss_and_grads(torch, model, cfg, graph, taken=None) -> list:
    """[loss, every parameter's gradient] of dimenet.loss_fn; with a dict
    ``taken``, the run's bases ("rbf", "sbf": what radial_basis and
    spherical_basis returned) and each ReLU's mask (out > 0; "relu", in
    call order) are stored in it."""
    from repro_torch.models import dimenet
    if taken is None:
        loss, _ = dimenet.loss_fn(model, cfg, graph)
    else:
        bases = dimenet.radial_basis, dimenet.spherical_basis, torch.relu
        taken["relu"] = []

        def rbf(*args):
            taken["rbf"] = bases[0](*args).detach()
            return taken["rbf"]

        def sbf(*args):
            taken["sbf"] = bases[1](*args).detach()
            return taken["sbf"]

        def relu(x):
            out = bases[2](x)
            taken["relu"].append(out > 0)
            return out
        with patched(dimenet, radial_basis=rbf, spherical_basis=sbf), \
                patched(torch, relu=relu):
            loss, _ = dimenet.loss_fn(model, cfg, graph)
    return [loss.detach()] + list(torch.autograd.grad(
        loss, list(model.parameters())))


def gnn_float64_grads(torch, model, cfg, graph, taken=None) -> list:
    """gnn_loss_and_grads of a float64 copy of ``model`` on the card, its
    scatters and gathers as plain float64 index_add_ / indexing (the
    yardstick of the card-against-CPU check, off the port's path). What
    ``taken`` holds of a float32 run (gnn_loss_and_grads) it takes over:
    that run's bases, widened, and its ReLU branches; the rest it
    computes itself."""
    import copy
    from repro_torch.models import dimenet
    taken = taken or {}

    def segment_sum(data, ids, n, plan=None):
        keep = ids >= 0
        return torch.zeros((n, data.shape[1]), dtype=data.dtype,
                           device=data.device).index_add(
            0, ids[keep].long(), data[keep])

    def gather(table, ids, plan=None):
        return table[ids.clamp_min(0).long()] * (ids >= 0)[:, None]

    def given(key, fn):
        if key not in taken:
            return fn
        return lambda d, *rest: taken[key].to(d.device, d.dtype)

    calls, plain_relu = iter(taken.get("relu", ())), torch.relu

    def relu(x):
        mask = next(calls, None)
        if mask is None:
            if "relu" in taken:
                raise AssertionError("gnn: the float64 run made more ReLU "
                                     "calls than the run it follows")
            return plain_relu(x)
        return x * mask.to(x.device, x.dtype)

    wide = copy.deepcopy(model).double()
    graph = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
             else v for k, v in graph.items()}
    with patched(dimenet, segment_sum=segment_sum, _gather=gather,
                 radial_basis=given("rbf", dimenet.radial_basis),
                 spherical_basis=given("sbf", dimenet.spherical_basis)), \
            patched(torch, relu=relu):
        out = gnn_loss_and_grads(torch, wide, cfg, graph)
    if next(calls, None) is not None:
        raise AssertionError("gnn: the float64 run made fewer ReLU calls "
                             "than the run it follows")
    return out


def same_bits(torch, a, b) -> bool:
    """Equal float32 tensors bit for bit (signed zeros and NaNs apart)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def gnn_kernel_cases(cfg, hosts: dict) -> list:
    """(name, cell, kernel, ids on the host (padding as -1), rows of the
    output or table, D) for each shape gnn_kernel_checks holds: at
    minibatch_lg the agg (T x H into E by t_ji), the node readout (E x H
    into N by dst) and the bag at (m @ w_kj)[t_kj]; at molecule the graph
    readout (N x d_out into G by graph_id) and its gradient, the one-id
    bag at D = d_out."""
    import numpy as np
    big, mol = hosts["minibatch_lg"], hosts["molecule"]
    t_valid = (big["t_kj"] >= 0) & (big["t_ji"] >= 0)
    e, n = len(big["src"]), len(big["node_mask"])
    g_ids = np.where(mol["node_mask"], mol["graph_id"], -1)
    n_graphs = len(mol["y_graph"])
    h = cfg.d_hidden
    return [
        ("agg", "minibatch_lg", "embedding_bag_backward",
         np.where(t_valid, big["t_ji"], -1), e, h),
        ("node_readout", "minibatch_lg", "embedding_bag_backward",
         np.where(big["edge_mask"], big["dst"], -1), n, h),
        ("gather_w_kj", "minibatch_lg", "embedding_bag",
         np.where(t_valid, big["t_kj"], -1), e, h),
        ("graph_readout", "molecule", "embedding_bag_backward", g_ids,
         n_graphs, cfg.d_out),
        ("gather_graph_readout", "molecule", "embedding_bag", g_ids,
         n_graphs, cfg.d_out)]


def grouping_check(torch, ids, rows: int, gpu: str) -> tuple:
    """bag_grouping of ``ids`` (int32 on the card) over ``rows`` rows:
    exact against its plain version (order, rows, starts, U), timed (one
    call, device) beside the plain version and the library call
    torch.sort(stable=True) of the flat ids, which the port does not call
    on the card. Bound: the ids read once, the plan written once. Returns
    (the entry, the plan)."""
    from repro_torch.kernels.embedding_bag import bag_grouping_cuda, \
        bag_grouping_ref
    plan = bag_grouping_cuda(ids, rows)
    want = bag_grouping_ref(ids, rows)
    got, exp = plan.used(), want.used()
    exact = all(a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(got, exp))
    err = max((float((a.long() - b.long()).abs().max()) if a.numel() else
               0.0) if a.shape == b.shape else math.inf
              for a, b in zip(got, exp))
    order, runs, starts = exp
    lengths = starts[1:] - starts[:-1]
    flat = ids.reshape(-1)
    bmin, by = bound(4 * (flat.numel() + order.numel() + 2 * runs.numel()
                          + 1), 0, gpu)

    def library():
        return torch.sort(flat, stable=True)
    entry = dict(
        kernel="bag_grouping", exact=exact, max_abs_err=err,
        ms=time_ms(lambda: bag_grouping_cuda(ids, rows), 10, 2),
        device_ms=queued_ms(torch, lambda: bag_grouping_cuda(ids, rows),
                            calls=8),
        plain_ms=time_ms(lambda: bag_grouping_ref(ids, rows), 3, 1),
        bound_ms=bmin, bound_by=by, library_ms=time_ms(library, 10, 2),
        library_device_ms=queued_ms(torch, library, calls=8),
        library_call="torch.sort(stable=True) of the flat ids",
        ids=flat.numel(), ids_valid=order.numel(), runs=runs.numel(),
        longest_run=int(lengths.max()) if lengths.numel() else 0,
        rows=rows)
    return entry, plan


def gnn_segment_sum_check(torch, ids, segs: int, d: int, gpu: str,
                          g) -> dict:
    """segment_sum (the backward kernel with one id per row) of normal
    (rows, d) data by ``ids`` into ``segs`` segments, over a prepared plan
    and with the plan built inside the call: both bit-equal to its plain
    version on the card; the grouping alone (grouping_check), the sum
    over the plan and the two together timed (one call, device) beside the
    plain version and the library call (index_add_ into torch.zeros over
    the valid rows), which the port never calls."""
    from repro_torch.kernels.embedding_bag import \
        embedding_bag_backward_ref, segment_sum
    grouping, plan = grouping_check(torch, ids, segs, gpu)
    data = torch.randn((ids.shape[0], d), generator=g, device=ids.device)
    got = segment_sum(data, ids, segs, plan)
    inside = segment_sum(data, ids, segs)
    want = embedding_bag_backward_ref(data, ids[:, None], None, "sum", segs)
    equal = same_bits(torch, got, want) and same_bits(torch, inside, want)
    err = float((got - want).abs().max())
    keep = ids >= 0
    lib_ids, lib_data = ids[keep].long(), data[keep].contiguous()

    def lib():
        return torch.zeros((segs, d), device=ids.device).index_add_(
            0, lib_ids, lib_data)
    lib_err = float((lib() - got).abs().max())
    del got, inside, want
    n_valid = int(keep.sum())
    bmin, by = bound(n_valid * d * 4 + ids.numel() * 4 + segs * d * 4,
                     n_valid * d, gpu)

    def planned():
        return segment_sum(data, ids, segs, plan)

    def grouped_inside():
        return segment_sum(data, ids, segs)
    return dict(
        kernel="embedding_bag_backward", bit_equal_to_plain=equal,
        max_abs_err=err, ms=time_ms(planned, 10, 2),
        device_ms=queued_ms(torch, planned, calls=8),
        with_grouping_ms=time_ms(grouped_inside, 10, 2),
        with_grouping_device_ms=queued_ms(torch, grouped_inside, calls=8),
        plain_ms=time_ms(lambda: embedding_bag_backward_ref(
            data, ids[:, None], None, "sum", segs), 3, 1),
        bound_ms=bmin, bound_by=by, library_ms=time_ms(lib, 10, 2),
        library_device_ms=queued_ms(torch, lib, calls=8),
        library_max_abs_err=lib_err,
        library_call="torch.zeros(S, D).index_add_ over the valid rows",
        grouping=grouping, longest_run=grouping["longest_run"],
        shape=dict(rows=ids.shape[0], rows_valid=n_valid, segments=segs,
                   d=d))


def gnn_bag_check(torch, ids, rows: int, d: int, gpu: str, g) -> dict:
    """The one-id bag (a row gather of a normal (rows, d) table by
    ``ids``): bit-equal to its plain version on the card, timed beside it
    and the library call (F.embedding_bag over the valid ids with an
    empty bag per pad), which the port never calls."""
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, \
        embedding_bag_ref
    ids = ids[:, None].contiguous()
    table = torch.randn((rows, d), generator=g, device=ids.device)
    got = embedding_bag_cuda(table, ids, None, "sum")
    want = embedding_bag_ref(table, ids, None, "sum")
    equal = same_bits(torch, got, want)
    err = float((got - want).abs().max())
    keep = ids[:, 0] >= 0
    lib_ids = ids[keep, 0].long()
    offsets = torch.cumsum(keep.long(), 0) - keep.long()   # pads: empty

    def lib():
        return torch.nn.functional.embedding_bag(lib_ids, table, offsets,
                                                 mode="sum")
    lib_err = float((lib() - got).abs().max())
    del got, want
    uniq = int(torch.unique(lib_ids).numel())
    bmin, by = bound(uniq * d * 4 + ids.numel() * 4 + ids.shape[0] * d * 4,
                     0, gpu)
    return dict(
        kernel="embedding_bag", bit_equal_to_plain=equal, max_abs_err=err,
        ms=time_ms(lambda: embedding_bag_cuda(table, ids, None, "sum"), 10,
                   2),
        device_ms=queued_ms(torch, lambda: embedding_bag_cuda(
            table, ids, None, "sum"), calls=8),
        plain_ms=time_ms(lambda: embedding_bag_ref(table, ids, None, "sum"),
                         3, 1),
        bound_ms=bmin, bound_by=by, library_ms=time_ms(lib, 10, 2),
        library_max_abs_err=lib_err,
        library_call="F.embedding_bag (sum) over the valid ids, an empty "
                     "bag per pad",
        shape=dict(rows=ids.shape[0], rows_valid=int(keep.sum()),
                   table_rows=rows, unique_rows=uniq, d=d))


def gnn_kernel_checks(torch, cfg, hosts: dict, gpu: str, seed: int) -> dict:
    """Both bag kernels at each of gnn_kernel_cases' shapes, on normal
    data with the batch's ids (padding as -1), and segment_sum on GNN_HUB's
    ids: each entry bit-equal to its plain version on the card and timed
    (gnn_segment_sum_check, with the grouping's entry under "grouping";
    gnn_bag_check)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1717)
    out = {}
    for name, cell, kernel, ids, rows, d in gnn_kernel_cases(cfg, hosts):
        ids = torch.from_numpy(ids).to(dev).int().contiguous()
        check = gnn_segment_sum_check if kernel == "embedding_bag_backward" \
            else gnn_bag_check
        out[name] = dict(check(torch, ids, rows, d, gpu, g), cell=cell)
    h = GNN_HUB
    ids = torch.randint(0, h["segments"], (h["rows"],), generator=g,
                        device=dev, dtype=torch.int32)
    ids[torch.randperm(h["rows"], generator=g, device=dev)[:h["hub"]]] = 5
    out["hub"] = dict(gnn_segment_sum_check(torch, ids, h["segments"],
                                            h["d"], gpu, g), cell="synthetic")
    return out


def gnn_cli_phase(src: Path) -> None:
    """GNN_CLI_RUNS at once, on the card by default: the train launcher
    must exit 0 and print the reference's line, the serve launcher exit 1
    with the reference's message."""
    import os
    import re
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", module, *args],
                              env={**os.environ, "PYTHONPATH": str(src)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _, module, args in GNN_CLI_RUNS]
    failed = []
    for (name, module, args), proc in zip(GNN_CLI_RUNS, procs):
        try:
            out, err = proc.communicate(timeout=GNN_CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        line = out.strip().splitlines()[-1] if out.strip() else ""
        if name == "train":
            ok = proc.returncode == 0 and re.fullmatch(
                r"dimenet: trained 4 steps; history=\[\d+\.\d+"
                r"(, \d+\.\d+){3}\]", line) is not None
        else:
            line = err.strip().splitlines()[-1] if err.strip() else ""
            ok = proc.returncode == 1 and \
                line == "gnn serving = scoring; use launch/train.py"
        emit("gnn_cli", run=name, args=[module, *args],
             returncode=proc.returncode, output=line,
             seconds=time.perf_counter() - t,
             stderr_tail=err[-2000:] if not ok else "")
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"gnn_cli: the dimenet launchers failed or "
                             f"printed another line: {failed}")


def gnn_phase(torch, src: Path, gpu: str, seed: int, wrappers: dict) -> dict:
    """DimeNet at its published config (item 10.6c) on GNN_CELLS, each
    batch built on the host from ``seed``; GNN_SKIPPED printed with its
    reason. The main path: GNN_STEPS steps of each cell, its launch counts
    zeroed just before and read just after; finite losses, every parameter
    moved, each step's launches of both bag kernels and bag_grouping equal
    to gnn_step_launches' and no other kernel (asserted). Then: the first step's loss and gradients twice at
    GNN_DETERMINISM_CELL, bit-equal to each other and to the step's loss;
    the card against the CPU at GNN_CPU_CELLS, the gradients' errors to a
    float64 run on each run's own bases and ReLU branches within
    GNN_F64_RATIO of the CPU's (worst leaf and median leaf); the
    kernels at gnn_kernel_cases' shapes and GNN_HUB (bit-equal, the
    grouping exact); one profiled
    step there; the launchers (gnn_cli_phase). Returns the launches over
    the main path and the kernels' entries."""
    import copy
    from repro_torch.configs import get_arch
    from repro_torch.data.graph_sampler import graph_to_device

    cfg = get_arch("dimenet").config
    dev = torch.device("cuda")
    for cell, why in GNN_SKIPPED.items():
        emit("gnn_skip", cell=cell, reason=why)
    hosts, graphs = {}, {}
    for cell in GNN_CELLS:
        t = time.perf_counter()
        hosts[cell] = gnn_batch(cell, seed)
        emit("gnn_batch", cell=cell, host_seconds=time.perf_counter() - t,
             **gnn_counts(hosts[cell]))
        graphs[cell] = graph_to_device(hosts[cell], dev)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts(wrappers)
    runs, kept = {}, {}
    for cell in GNN_CELLS:
        d_feat = hosts[cell]["x"].shape[1] if "x" in hosts[cell] else 0
        run, *rest = gnn_train_cell(torch, cfg, graphs[cell], d_feat, seed,
                                    wrappers)
        runs[cell], kept[cell] = run, rest
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}

    for cell in GNN_CELLS:
        run, c = runs[cell], gnn_counts(hosts[cell])
        flops = gnn_step_flops(cfg, c["nodes"], c["edges"], c["triplets"],
                               c["d_feat"])
        flops_real = gnn_step_flops(cfg, c["nodes_real"], c["edges_real"],
                                    c["triplets_real"], c["d_feat"])
        n_params = run["params_count"]
        step_bytes = gnn_step_bytes(hosts[cell], c, n_params, real=False)
        bytes_real = gnn_step_bytes(hosts[cell], c, n_params, real=True)
        bmin, by = bound(step_bytes, flops, gpu)
        breal, by_real = bound(bytes_real, flops_real, gpu)
        # the share against the work the real rows need comes first: the
        # padded rows are work a later change may drop
        emit("gnn_train", cell=cell, config=cfg.name, **c, **run,
             bound_ms_real_rows=breal, bound_by_real_rows=by_real,
             share_of_bound_real_rows=breal / run["step_ms_median"],
             step_flops_real_rows=flops_real, step_bytes_real_rows=bytes_real,
             padded_share=dict(nodes=1 - c["nodes_real"] / c["nodes"],
                               edges=1 - c["edges_real"] / c["edges"],
                               triplets=1 - c["triplets_real"]
                               / c["triplets"],
                               step_flops=1 - flops_real / flops),
             bound_ms=bmin, bound_by=by,
             share_of_bound=bmin / run["step_ms_median"],
             step_flops=flops, step_bytes=step_bytes)
        want = gnn_step_launches(cfg, hosts[cell])
        every = all(s == want for s in run["launches_per_step"])
        if not all(math.isfinite(x) for x in run["losses"]) \
                or run["params_moved"] != run["params"] or not every:
            raise AssertionError(f"gnn {cell}: a non-finite loss, a "
                                 f"parameter that did not move, or a step "
                                 f"whose launches are not {want}: {run}")
    others = {k: v for k, v in launches.items()
              if k not in GNN_KERNELS and v}
    if others:
        raise AssertionError(f"gnn: another kernel launched on the DimeNet "
                             f"path: {others}")

    # the first step's loss and gradients, twice, from the same weights
    cell = GNN_DETERMINISM_CELL
    _, _, _, init = kept[cell]
    a = gnn_loss_and_grads(torch, init, cfg, graphs[cell])
    b = gnn_loss_and_grads(torch, init, cfg, graphs[cell])
    same = all(same_bits(torch, x, y) for x, y in zip(a, b))
    step_loss = float(a[0]) == runs[cell]["losses"][0]
    emit("gnn_determinism", cell=cell, tensors=len(a), bit_equal=same,
         equal_to_the_step_loss=step_loss, loss=float(a[0]))
    if not (same and step_loss):
        raise AssertionError(f"gnn: two runs of {cell}'s first step differ "
                             f"(bit_equal {same}, step loss {step_loss})")
    del a, b

    # the card against the CPU on the same weights and batch
    for cell in GNN_CPU_CELLS:
        init = kept[cell][3]
        t = time.perf_counter()
        card_took, cpu_took = {}, {}
        card = gnn_loss_and_grads(torch, init, cfg, graphs[cell], card_took)
        cpu = gnn_loss_and_grads(torch, copy.deepcopy(init).cpu(), cfg,
                                 graph_to_device(hosts[cell], "cpu"),
                                 cpu_took)
        card_wide = [x.cpu() for x in gnn_float64_grads(
            torch, init, cfg, graphs[cell], card_took)]
        cpu_wide = [x.cpu() for x in gnn_float64_grads(
            torch, init, cfg, graphs[cell], cpu_took)]
        flips = sum(int((a.cpu() != b).sum()) for a, b in zip(
            card_took["relu"], cpu_took["relu"]))
        units = sum(a.numel() for a in card_took["relu"])
        bases_err = {k: float((card_took[k].cpu().double() - cpu_took[k])
                              .abs().max()) / float(cpu_took[k].abs().max())
                     for k in ("rbf", "sbf")}
        del card_took, cpu_took
        names = ["loss"] + [n for n, _ in init.named_parameters()]

        def errs_of(xs, ys):
            return {name: float((x.cpu().double() - y.cpu().double())
                                .abs().max()) / (float(y.abs().max()) or 1.0)
                    for name, x, y in zip(names, xs, ys)}
        errs, card64, cpu64 = errs_of(card, cpu), errs_of(card, card_wide), \
            errs_of(cpu, cpu_wide)
        leaves = names[1:]
        card_worst = max(leaves, key=card64.get)
        cpu_worst = max(leaves, key=cpu64.get)
        card_median = statistics.median(card64[n] for n in leaves)
        cpu_median = statistics.median(cpu64[n] for n in leaves)
        worst = max(leaves, key=errs.get)
        ok = errs["loss"] <= GNN_CPU_LOSS_RTOL and \
            card64[card_worst] <= GNN_F64_RATIO * cpu64[cpu_worst] and \
            card_median <= GNN_F64_RATIO * cpu_median
        emit("gnn_cpu", cell=cell, seconds=time.perf_counter() - t,
             loss_card=float(card[0]), loss_cpu=float(cpu[0]),
             loss_float64=float(card_wide[0]), loss_rel_err=errs["loss"],
             loss_rtol=GNN_CPU_LOSS_RTOL, ratio=GNN_F64_RATIO,
             leaves=len(leaves), relu_units=units,
             relu_masks_card_vs_cpu=flips, bases_card_vs_cpu=bases_err,
             card_worst_leaf=card_worst,
             card_worst_err_to_float64=card64[card_worst],
             cpu_worst_leaf=cpu_worst,
             cpu_worst_err_to_float64=cpu64[cpu_worst],
             worst_over_worst=card64[card_worst] / cpu64[cpu_worst],
             card_median_err_to_float64=card_median,
             cpu_median_err_to_float64=cpu_median,
             median_over_median=card_median / cpu_median,
             worst_leaf_card_vs_cpu=worst,
             worst_leaf_card_vs_cpu_err_of_scale=errs[worst])
        if not ok:
            raise AssertionError(
                f"gnn {cell}: the card's loss differs from the CPU's past "
                f"{GNN_CPU_LOSS_RTOL}, or its gradients lie further from "
                f"float64 than {GNN_F64_RATIO} x the CPU's (worst leaf "
                f"{card_worst} {card64[card_worst]:.3g} against "
                f"{cpu64[cpu_worst]:.3g}, median {card_median:.3g} against "
                f"{cpu_median:.3g})")
        del card, cpu, card_wide, cpu_wide

    kernels = gnn_kernel_checks(torch, cfg, hosts, gpu, seed)
    emit("gnn_kernels", shapes=kernels)
    bad = [k for k, v in kernels.items() if not v["bit_equal_to_plain"]
           or not v.get("grouping", {"exact": True})["exact"]]
    if bad:
        raise AssertionError(f"gnn: a bag kernel or the grouping differs "
                             f"from its plain version at {bad}")

    model, state, step, _ = kept["minibatch_lg"]
    prof = profile_busy(torch, lambda: step(model, state,
                                            graphs["minibatch_lg"]))
    emit("gnn_profile", cell="minibatch_lg", profile=prof,
         busy_share=None if prof["device_busy_ms"] is None else
         prof["device_busy_ms"] / prof["profiled_wall_ms"])
    del kept, graphs, model, state
    torch.cuda.empty_cache()
    gnn_cli_phase(src)
    return dict(launches=launches, kernels=kernels)


DRYRUN_JOBS = 4                  # worker processes of the meta sweep
DRYRUN_TIMEOUT = 900             # s from its start, in the background
DRYRUN_KERNELS = ("beam_hops", "l2topk", "embedding_bag",
                  "embedding_bag_backward", "bag_grouping")


def start_dryrun_sweep(src: Path) -> dict:
    """Start phase 18's meta sweep (launch.dryrun on the production
    meshes; no card: CUDA_VISIBLE_DEVICES is empty) in the background;
    it is killed at exit if it still runs."""
    out = src.parent / "build" / "dryrun_meta"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    log = open(out / "sweep.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--include-ann", "--mesh", "single", "multi", "--jobs",
         str(DRYRUN_JOBS), "--out", str(out), "--force"],
        stdout=log, stderr=subprocess.STDOUT, cwd=src.parent,
        env=dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES=""))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "t0": time.perf_counter(), "out": out, "log": log}


def dryrun_phase(torch, src: Path, sweep: dict, wrappers: dict,
                 seed: int) -> dict:
    """Phase 18 (the module docstring)."""
    from repro_torch.configs import get_arch, iter_cells
    from repro_torch.launch.dryrun import run_cell_cuda
    proc = sweep["proc"]
    proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT
                          - (time.perf_counter() - sweep["t0"])))
    sweep["log"].close()
    text = (sweep["out"] / "sweep.log").read_text()
    done = [ln for ln in text.splitlines() if ln.startswith("done:")]
    if proc.returncode != 0 or not done:
        raise AssertionError(f"the meta dry run failed (exit "
                             f"{proc.returncode}):\n{text[-3000:]}")
    tally = dict(kv.split("=") for kv in done[-1].split()[1:])
    recs = {}
    for f in sweep["out"].glob("*.json"):
        r = json.loads(f.read_text())
        if r.get("package") != "repro_torch" or \
                not f.name.endswith("__torch.json"):
            raise AssertionError(f"dry run record {f.name} is not the "
                                 f"port's: {r.get('package')}")
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    want = {(a, s_, m) for a, s_, _ in iter_cells(include_ann=True)
            for m in ("16x16", "2x16x16")}
    if set(recs) != want or int(tally["err"]) != 0:
        raise AssertionError(f"the meta dry run covers {len(recs)} of "
                             f"{len(want)} cells, err={tally['err']}")
    for (a, s_, m), r in recs.items():
        reason = get_arch(a).skip_reason(s_)
        if (r["status"] == "skipped") != bool(reason) or \
                r.get("reason", reason) != reason or \
                r["status"] not in ("ok", "skipped"):
            raise AssertionError(f"dry run {a} {s_} {m}: {r['status']} "
                                 f"{r.get('reason')}")
    slowest = sorted(((r["run_s"], f"{a} {s_} {m}") for (a, s_, m), r
                      in recs.items() if r["status"] == "ok"))[-3:]
    emit("dryrun_meta", seconds=float(tally["seconds"]),
         wall_seconds=time.perf_counter() - sweep["t0"], ok=int(tally["ok"]),
         skipped=int(tally["skip"]), err=int(tally["err"]),
         jobs=DRYRUN_JOBS, slowest=slowest)
    for (a, s_, m), r in sorted(recs.items()):
        if r["status"] == "ok" and r["kind"] == "train":
            print(f"dryrun_train {a:20s} {s_:15s} {m:8s} "
                  f"link_bytes_per_device {r['link_bytes_per_device']!r} "
                  f"all-reduce {r['collective_counts'].get('all-reduce', 0)} "
                  f"bytes_per_device {r['bytes_per_device']!r} "
                  f"partition {r['partition']}", flush=True)

    out = src.parent / "build" / "dryrun_cuda"
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    before = {name: w.launches for name, w in wrappers.items()}
    rows = []
    for arch, shape, _ in iter_cells(include_ann=True):
        r = run_cell_cuda(arch, shape, str(out), seed)
        if r.get("package") != "repro_torch":
            raise AssertionError(f"dry run {arch} {shape}: the card record "
                                 f"names {r.get('package')}")
        if r["status"] != "ok":
            emit("dryrun_cell", arch=arch, shape=shape, skipped=r["reason"])
            continue
        emit("dryrun_cell", arch=arch, shape=shape, kind=r["kind"],
             ms=r["ms"], ms_runs=r["ms_runs"], roofline_ms=r["roofline_ms"],
             share=r["share"], bottleneck=r["bottleneck"],
             flops=r["flops"], bytes=r["bytes"], meta_flops=r["meta_flops"],
             meta_bytes=r["meta_bytes"], peak_bytes=r["peak_bytes"],
             meta_peak_bytes=r["meta_peak_bytes"],
             args_on_card=r["args_on_card"], launches=r["launches"],
             counted_kernels=r["counted_kernels"])
        if not r["counts_equal"]:
            raise AssertionError(f"dry run {arch} {shape}: the card counted "
                                 f"{r['flops']} FLOPs / {r['bytes']} bytes, "
                                 f"meta {r['meta_flops']} / "
                                 f"{r['meta_bytes']}")
        if not r["peak_covered"]:
            raise AssertionError(f"dry run {arch} {shape}: meta peak "
                                 f"{r['meta_peak_bytes']} under the card's "
                                 f"{r['peak_bytes']} by more than 10%")
        rows.append(r)
    launches = {name: w.launches - before[name]
                for name, w in wrappers.items()}
    for r in rows:
        print(f"dryrun {r['arch']:20s} {r['shape']:15s} "
              f"{r['ms']:10.3f} ms  roofline {r['roofline_ms']:9.3f} ms "
              f"({r['bottleneck']}) share {r['share']:.4f}  peak "
              f"{r['peak_bytes'] / 1e9:.3f} GB (meta "
              f"{r['meta_peak_bytes'] / 1e9:.3f})", flush=True)
    if min(launches[k] for k in DRYRUN_KERNELS) <= 0:
        raise AssertionError(f"a kernel never launched in the dry run's "
                             f"card cells: {launches}")
    return {"launches": launches, "cells": len(rows)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-only", action="store_true",
                    help="run the device and LM phases alone; no result "
                         "line")
    ap.add_argument("--gnn-only", action="store_true",
                    help="run the device, build and gnn phases alone; no "
                         "result line")
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    load_peaks()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gpu = torch.cuda.get_device_name(0)
    emit("device", kind=gpu, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    peaks(gpu)                  # the bounds need this card's data sheet
    if args.lm_only:
        emit("lm_only", seconds=lm_phases(torch, src, gpu, args.seed,
                                          smi))
        return 0

    # 2. build the kernels
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=lib.build_seconds, ptxas=ptxas)
    if args.gnn_only:
        from repro_torch.kernels.embedding_bag import bag_grouping_cuda, \
            embedding_bag_cuda, embedding_bag_backward_cuda
        t = time.perf_counter()
        gnn = gnn_phase(torch, src, gpu, args.seed, {
            "embedding_bag": embedding_bag_cuda,
            "embedding_bag_backward": embedding_bag_backward_cuda,
            "bag_grouping": bag_grouping_cuda})
        emit("gnn_only", seconds=time.perf_counter() - t,
             launches_gnn=gnn["launches"])
        return 0
    sweep = start_dryrun_sweep(src)     # 18's meta sweep, on the host

    # 3. kernels at the main path's shapes, against their plain versions
    from repro_torch.configs.ann_laion import ANN_SHAPES, CONFIG
    n, n_queries = CONFIG.n_database, ANN_SHAPES["search_300k"].batch
    n_kept = max(1, math.ceil(CONFIG.antihub_keep * n))     # as antihub does
    t = time.perf_counter()
    kernels = kernel_phase(torch, n_kept, CONFIG.pca_dim, gpu, args.seed)
    kernels.update(hop_loop_phase(torch, n_kept, CONFIG.pca_dim, gpu,
                                  args.seed))
    for name, by_mode in mode_kernel_phase(torch, n_kept, CONFIG.pca_dim,
                                           gpu, args.seed).items():
        kernels[name]["by_mode"] = by_mode
    kernels["l2topk"] = l2topk_kernel_phase(torch, gpu, args.seed)
    torch.cuda.synchronize()
    emit("kernels", seconds=time.perf_counter() - t, kernels=kernels)
    from repro_torch.kernels.beam_hop import beam_hops_lut_cuda
    checked_variants = dict(beam_hops_lut_cuda.by_variant)
    if min(checked_variants.values()) <= 0:
        raise AssertionError(f"a LUT loop variant never launched in the "
                             f"kernels phase: {checked_variants}")

    # 4-5. the main path: fit, then serve — launch counts from these only
    from repro_torch.core.distances import l2_topk
    from repro_torch.core.build.finish import reachable_from
    from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
    from repro_torch.data import clustered_vectors, queries_like
    from repro_torch.core.beam_search import beam_search
    from repro_torch.kernels.alpha_scan import alpha_scan_cuda
    from repro_torch.kernels.alpha_scan import ops as scan_ops
    from repro_torch.kernels.beam_hop import beam_hop_cuda, \
        beam_hop_lut_cuda, beam_hops_cuda, beam_hops_lut_cuda
    from repro_torch.kernels.embedding_bag import bag_grouping_cuda, \
        embedding_bag_cuda, embedding_bag_backward_cuda
    from repro_torch.kernels.gather_dist import gather_dist_cuda
    from repro_torch.kernels.l2topk import l2topk_cuda
    from repro_torch.kernels.lut_dist import lut_dist_cuda
    from repro_torch.kernels.topk_merge import topk_merge_cuda
    from repro_torch.kernels.topk_merge.topk_merge import \
        route as topk_route
    wrappers = {"gather_dist": gather_dist_cuda, "beam_hop": beam_hop_cuda,
                "beam_hops": beam_hops_cuda, "topk_merge": topk_merge_cuda,
                "lut_dist": lut_dist_cuda, "beam_hop_lut": beam_hop_lut_cuda,
                "beam_hops_lut": beam_hops_lut_cuda, "l2topk": l2topk_cuda,
                "embedding_bag": embedding_bag_cuda,
                "embedding_bag_backward": embedding_bag_backward_cuda,
                "bag_grouping": bag_grouping_cuda,
                "alpha_scan": alpha_scan_cuda}
    recorder = ScanRecorder(torch, scan_ops)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    data = clustered_vectors(gen, n, CONFIG.dim)
    queries = queries_like(gen, data, n_queries)
    params = IndexParams.from_config(CONFIG, knn_backend="exact",
                                     finish_backend="host")
    torch.cuda.synchronize()
    zero_counts(wrappers)
    fit_syncs = beam_search.host_syncs
    t = time.perf_counter()
    index = TunedGraphIndex(params, device="cuda").fit(
        data, torch.Generator().manual_seed(args.seed))
    fit_s = time.perf_counter() - t
    fit_syncs = beam_search.host_syncs - fit_syncs
    fit_launches = {name: w.launches for name, w in wrappers.items()}
    fit_l2topk = l2topk_cuda.launches
    fit_by_variant = dict(l2topk_cuda.by_variant)
    fit_topk_by_variant = dict(topk_merge_cuda.by_variant)
    fit_scan_by_variant = dict(alpha_scan_cuda.by_variant)
    nbrs = index.graph.neighbors
    reach = reachable_from(nbrs.cpu().numpy(), int(index.graph.medoid))
    degree_ok = bool(((nbrs >= 0).sum(1) <= params.graph_degree).all())
    bs = index.build_stats
    emit("fit", seconds=fit_s, n=n, n_kept=index.ntotal,
         dim=CONFIG.dim, pca_dim=params.pca_dim,
         stage_seconds=index.stage_seconds,
         reachable=float(reach.mean()), degree_ok=degree_ok,
         pool_evals=bs.pool_evals, prune_evals=bs.prune_evals,
         repair_rounds=bs.repair_rounds, launches=fit_launches,
         hop_loop_host_syncs=fit_syncs, l2topk_launches=fit_l2topk,
         l2topk_launches_by_variant=fit_by_variant,
         topk_merge_launches_by_variant=fit_topk_by_variant,
         memory_bytes=index.memory_bytes(),
         peak_device_bytes=torch.cuda.max_memory_allocated())
    if index.ntotal != n_kept:
        raise AssertionError(f"fit kept {index.ntotal} rows; the kernel "
                             f"phase ran at {n_kept}")
    check_scans("fit", fit_launches, index.ntotal)
    if not reach.all() or not degree_ok:
        raise AssertionError("graph not reachable from the medoid, or a "
                             "row exceeds the degree")
    # every pool assembly (one topk_pool per chunk) on the routed variant
    pool_variant = topk_route(TOPK_SHAPE["m"])
    if fit_launches["topk_merge"] <= 0 or fit_topk_by_variant != {
            v: fit_launches["topk_merge"] if v == pool_variant else 0
            for v in fit_topk_by_variant}:
        raise AssertionError(f"the fit's pool assembly did not all run "
                             f"topk_merge's {pool_variant} variant: "
                             f"{fit_topk_by_variant}")

    k, ef = CONFIG.k, CONFIG.ef_search
    index.search(queries, k, ef=ef, hop_backend="fused")       # warm
    serve_times = []
    for _ in range(SERVE_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d_f, i_f = index.search(queries, k, ef=ef, hop_backend="fused")
        torch.cuda.synchronize()
        serve_times.append(time.perf_counter() - t)
    serve_s = statistics.median(serve_times)
    stats_f = index.search_stats()
    launches = {name: w.launches for name, w in wrappers.items()}
    main_by_variant = dict(l2topk_cuda.by_variant)
    main_topk_by_variant = dict(topk_merge_cuda.by_variant)
    one = per_search(torch, wrappers, lambda: index.search(
        queries, k, ef=ef, hop_backend="fused"))

    l2_topk(queries, data, k)                                   # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, true_i = l2_topk(queries, data, k)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t
    recall = recall_at_k(i_f.cpu(), true_i.cpu())
    # every lane rides every loop iteration: hops + wasted is the same for
    # all of them
    iters = (stats_f["hops"] + stats_f["wasted_hops"]) / n_queries
    prof = profile_busy(torch, lambda: index.search(queries, k, ef=ef,
                                                    hop_backend="fused"))
    busy = prof["device_busy_ms"]
    emit("serve", queries=n_queries, k=k, ef=ef, runs=SERVE_RUNS,
         qps=n_queries / serve_s,
         qps_min=n_queries / max(serve_times),
         qps_max=n_queries / min(serve_times), seconds=serve_s,
         recall_at_10=recall, stats=stats_f,
         loop_iterations=iters, ms_per_iteration=serve_s * 1e3 / iters,
         device_busy_share=None if busy is None else
         busy / (serve_s * 1e3), profile=prof, per_search=one,
         l2topk_launches=launches["l2topk"] - fit_l2topk,
         brute_force_qps=n_queries / brute_s)
    if not (torch.isfinite(d_f).all() and i_f.shape == (n_queries, k)):
        raise AssertionError("search returned non-finite or mis-shaped "
                             "results")
    if one["launches"].get("beam_hops") != 1 or one["host_syncs"] != 1:
        raise AssertionError(f"a fused search took {one}, not one loop "
                             f"launch and one host sync")
    if recall < 0.80:
        raise AssertionError(f"recall@10 {recall} below the 0.80 floor")
    if args.seed == 0 and round(recall, 5) != BASELINE_SEED0["fit"]:
        raise AssertionError(f"recall@10 {recall} moved from the baseline's "
                             f"{BASELINE_SEED0['fit']} at seed 0")

    # 6. staged hop == fused hop, bit for bit
    d_s, i_s = index.search(queries, k, ef=ef, hop_backend="staged")
    stats_s = index.search_stats()
    same = (torch.equal(d_s, d_f) and torch.equal(i_s, i_f)
            and stats_s == stats_f)
    emit("staged", equal_to_fused=same, stats=stats_s)
    if not same:
        raise AssertionError("staged hop differs from the fused hop")

    # 7. a small input against the plain PyTorch versions, on the CPU: the
    # same index, REF_QUERIES queries (lanes do not interact, so a subset
    # of the batch has the same results). Dists to rtol = atol = 1e-5 (the
    # reduction order over D differs), ids on >= 99% of rows.
    cpu_index = TunedGraphIndex.from_state(index.state_dict(), device="cpu")
    nq = min(REF_QUERIES, n_queries)
    d_c, i_c = cpu_index.search(queries[:nq].cpu(), k, ef=ef,
                                hop_backend="fused")
    rows = float((i_c == i_f[:nq].cpu()).all(1).float().mean())
    close = torch.allclose(d_c, d_f[:nq].cpu(), rtol=1e-5, atol=1e-5)
    emit("reference", queries=nq, ids_equal_rows=rows, dists_close=close,
         max_abs_err=float((d_c - d_f[:nq].cpu()).abs().max()))
    if rows < 0.99 or not close:
        raise AssertionError("the card's search disagrees with the plain "
                             "PyTorch versions on the CPU")
    serve_compacted_phase(torch, index, queries, true_i, "f32", wrappers)

    # 8. quantized serving on the same index: pq (M = 300), then int8
    # (M = 600) — launch counts of the LUT kernels from these runs
    # (quantize + serve) only, kept per M
    lut_launches = {"lut_dist": {}, "beam_hop_lut": {}, "beam_hops_lut": {}}
    new_phase_s = {}            # wall seconds of this slice's phases
    lut_by_variant, loop_by_variant, lut_dist_by_variant = {}, {}, {}
    for backend, m in zip(("pq", "int8"), LUT_MS):
        counts = quantized_phase(torch, index, queries, true_i, backend,
                                 wrappers, args.seed)
        serve_compacted_phase(torch, index, queries, true_i, backend,
                              wrappers)
        if backend == "pq":
            # 8c. the exact/host index and its pq copy, saved and reloaded
            t = time.perf_counter()
            snapshot_phase(torch, index, queries, fit_s, data)
            new_phase_s["snapshot"] = time.perf_counter() - t
        for name in lut_launches:
            lut_launches[name][m] = counts[name]
        for v, c in counts["l2topk_by_variant"].items():
            lut_by_variant[v] = lut_by_variant.get(v, 0) + c
        loop_by_variant[str(m)] = counts["lut_loop_by_variant"]
        lut_dist_by_variant[str(m)] = counts["lut_dist_by_variant"]
    launches.update({name: sum(by_m.values())
                     for name, by_m in lut_launches.items()})

    # 8b. the config's own backends: NN-Descent, table pools, device finish
    recorder.on = {SCAN_SHAPES["prune"], SCAN_SHAPES["interconnect"]}
    auto_launches = fit_auto_phase(torch, data, queries, true_i, wrappers,
                                   args.seed, recall)

    # 9-10. the tuner on the same data, then its CLI at N = 20k
    recorder.on = {SCAN_SHAPES["reprune_family"]}
    tune_launches = tune_phase(torch, data, queries, wrappers, args.seed)
    recorder.on = set()
    tune_cli_phase(src)

    # 10b. alpha_scan on the pools fit_auto and the tuner gave it
    kernels["alpha_scan"] = alpha_scan_kernel_phase(
        torch, recorder.calls, gpu,
        {"fit": fit_scan_by_variant,
         "fit_auto": auto_launches["alpha_scan_by_variant"],
         "tune": tune_launches["alpha_scan_by_variant"]})
    emit("alpha_scan", **kernels["alpha_scan"])
    recorder.calls.clear()          # the fits' pools and bases it held
    torch.cuda.empty_cache()

    # 10c. the paper's Fig. 1 through the factory API on the same data
    t = time.perf_counter()
    factory_launches = factory_phase(torch, data, queries, true_i, wrappers,
                                     args.seed, gpu)
    new_phase_s["factory"] = time.perf_counter() - t

    # 10d-10e. the sharded and out-of-core tier on the same data, then the
    # streamed tier at four times the config's N
    t = time.perf_counter()
    sharded_launches, spmd, streamed = sharded_phase(
        torch, data, queries, true_i, wrappers, args.seed, gpu)
    new_phase_s["sharded"] = time.perf_counter() - t
    # 10f. the same tiers under each mode of the ANN toggles
    t = time.perf_counter()
    toggle_launches = sharded_toggles_phase(torch, data, queries, true_i,
                                            wrappers, args.seed, spmd,
                                            streamed)
    new_phase_s["sharded_toggles"] = time.perf_counter() - t
    del spmd, streamed
    torch.cuda.empty_cache()
    t = time.perf_counter()
    streamed_launches = streamed_phase(torch, wrappers, args.seed)
    new_phase_s["streamed"] = time.perf_counter() - t

    # 11-12. the two-tower path at full width: its launch counts are zeroed
    # just before recsys and read just after recsys_ann
    from repro_torch.configs.two_tower_retrieval import CONFIG as TWO_TOWER
    from repro_torch.models.recsys import two_tower_init
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = two_tower_init(torch.Generator(device="cuda").manual_seed(
        args.seed), TWO_TOWER)
    torch.cuda.synchronize()
    emit("recsys_init", seconds=time.perf_counter() - t,
         resident_bytes_before=resident)
    zero_counts(wrappers)
    recsys_phase(torch, model, TWO_TOWER, args.seed)
    recsys_ann_phase(torch, model, TWO_TOWER, args.seed)
    torch.cuda.synchronize()
    recsys_launches = {name: w.launches for name, w in wrappers.items()}
    recsys_by_variant = dict(l2topk_cuda.by_variant)
    recsys_topk_by_variant = dict(topk_merge_cuda.by_variant)
    launches["embedding_bag"] = recsys_launches["embedding_bag"]

    # 13-14. the launchers, then the bag kernel over the full table
    recsys_cli_phase(src)
    t = time.perf_counter()
    serve_cli_phase(src)
    new_phase_s["serve_cli"] = time.perf_counter() - t
    t = time.perf_counter()
    sharded_cli_phase(src)
    new_phase_s["sharded_cli"] = time.perf_counter() - t
    kernels["embedding_bag"] = embedding_bag_kernel_phase(
        torch, model.table.detach(), TWO_TOWER, gpu, args.seed)
    emit("embedding_bag", **kernels["embedding_bag"])

    # 14a. recsys training: the two-tower model above at full width (its
    # launch counts zeroed just before its steps and read just after), then
    # SASRec, DIN and DLRM, the Trainer's resume and the train launcher.
    # The ANN phases' index and data are done with: freed first.
    del index, cpu_index, data, queries, true_i
    torch.cuda.empty_cache()
    t = time.perf_counter()
    train_launches, kernels["embedding_bag_backward"], \
        kernels["bag_grouping"] = train_phase(torch, model, TWO_TOWER, gpu,
                                              args.seed, wrappers)
    for name in ("embedding_bag_backward", "bag_grouping"):
        launches[name] = train_launches[name]
    del model
    torch.cuda.empty_cache()
    train_models_phase(torch, args.seed, wrappers)
    trainer_phase(torch, args.seed)
    train_cli_phase(src)
    new_phase_s["train"] = time.perf_counter() - t

    # 14b. SASRec, DIN and DLRM at full width: no kernel of the port lies
    # on their paths; each wrapper's count must stay where it was
    before = {name: w.launches for name, w in wrappers.items()}
    t = time.perf_counter()
    recsys_models_phase(torch, args.seed)
    new_phase_s["recsys_models"] = time.perf_counter() - t
    models_launches = {name: w.launches - before[name]
                       for name, w in wrappers.items()}
    if any(models_launches.values()):
        raise AssertionError(f"a kernel launched on the SASRec, DIN or DLRM "
                             f"path, which has none: {models_launches}")

    # 16. the dense LMs: serving at full width, the checks, qwen2-1.5b's
    # training and the launchers; no kernel of the port lies on their path
    before = {name: w.launches for name, w in wrappers.items()}
    new_phase_s.update(lm_phases(torch, src, gpu, args.seed, smi))
    lm_launches = {name: w.launches - before[name]
                   for name, w in wrappers.items()}
    if any(lm_launches.values()):
        raise AssertionError(f"a kernel launched on the LM path, which has "
                             f"none: {lm_launches}")

    # 17. DimeNet: its segment sums and gathers' gradients on the bag
    # kernels; its launch counts zeroed just before its cells' steps and
    # read just after
    t = time.perf_counter()
    gnn = gnn_phase(torch, src, gpu, args.seed, wrappers)
    new_phase_s["gnn"] = time.perf_counter() - t

    # 18. the dry run: the meta sweep's result, then the cells one card
    # holds, each card run held to its meta run
    t = time.perf_counter()
    dry = dryrun_phase(torch, src, sweep, wrappers, args.seed)
    new_phase_s["dryrun"] = time.perf_counter() - t
    emit("new_phases", seconds=new_phase_s,
         total_seconds=sum(new_phase_s.values()),
         recsys_models_launches=models_launches, lm_launches=lm_launches,
         gnn_launches=gnn["launches"], dryrun_launches=dry["launches"])

    # 15. the kernels line. A LUT kernel's entry gives its M = 300 (pq)
    # times at the top, its total launches over both backends, and each
    # M's times and launches under by_m.
    line = []
    for name, info in kernels.items():
        entry = {k_: v for k_, v in info.items()
                 if k_ not in ("shape", "by_m", "by_shape")}
        entry["launches"] = launches[name]
        entry["launches_tune"] = tune_launches[name]
        entry["launches_fit_auto"] = auto_launches[name]
        entry["launches_recsys"] = recsys_launches[name]
        entry["launches_train"] = train_launches[name]
        entry["launches_factory"] = factory_launches[name]
        entry["launches_sharded"] = sharded_launches[name]
        entry["launches_streamed"] = streamed_launches[name]
        entry["launches_sharded_toggles"] = toggle_launches[name]
        entry["launches_gnn"] = gnn["launches"][name]
        entry["launches_dryrun"] = dry["launches"][name]
        if name == "bag_grouping":
            entry["by_shape_gnn"] = {
                s_: {k_: v for k_, v in b_["grouping"].items()
                     if k_ != "kernel"}
                for s_, b_ in gnn["kernels"].items() if "grouping" in b_}
        elif name in GNN_KERNELS:
            entry["by_shape_gnn"] = {
                s_: {k_: v for k_, v in b_.items()
                     if k_ not in ("kernel", "grouping")}
                for s_, b_ in gnn["kernels"].items() if b_["kernel"] == name}
        if "by_mode" in info:
            entry["by_mode"] = {
                m: {**info["by_mode"][m],
                    "launches": toggle_launches["by_mode"][name][m]}
                for m in MODE_NAMES}
        if "by_shape" in info:
            entry["by_shape"] = {s_: {k_: v for k_, v in b_.items()
                                      if k_ != "shape"} | b_["shape"]
                                 for s_, b_ in info["by_shape"].items()}
        if name == "l2topk":
            entry["launches_by_variant"] = main_by_variant
            entry["launches_by_variant_tune"] = tune_launches[
                "l2topk_by_variant"]
            entry["launches_by_variant_recsys"] = recsys_by_variant
            entry["launches_by_variant_quantize"] = lut_by_variant
            entry["launches_by_variant_fit_auto"] = auto_launches[
                "l2topk_by_variant"]
        if name == "topk_merge":
            entry["launches_by_variant"] = main_topk_by_variant
            entry["launches_by_variant_tune"] = tune_launches[
                "topk_merge_by_variant"]
            entry["launches_by_variant_recsys"] = recsys_topk_by_variant
            entry["launches_by_mode_fit_auto"] = auto_launches[
                "topk_merge_by_mode"]
        if name == "lut_dist":
            entry["launches_by_variant"] = lut_dist_by_variant
        if name == "alpha_scan":
            entry["launches_by_variant"] = fit_scan_by_variant
        if name == "beam_hops_lut":
            entry["launches_by_variant"] = loop_by_variant
            entry["launches_by_variant_kernels_phase"] = checked_variants
        if name in lut_launches:
            entry["m"] = LUT_MS[0]
            if "by_m" in info:
                entry["by_m"] = {
                    str(m): {**{k_: v for k_, v in info["by_m"][str(m)]
                                .items() if k_ != "shape"},
                             "launches": lut_launches[name][m]}
                    for m in LUT_MS}
            else:
                entry["launches_by_m"] = {str(m): lut_launches[name][m]
                                          for m in LUT_MS}
        entry["on_main_path"] = name not in OFF_PATH
        line.append({"name": name, **entry})
    print(json.dumps({"kernels": line}), flush=True)
    on_path = {name: c for name, c in launches.items() if name not in OFF_PATH}
    if min(on_path.values()) <= 0 or min(
            c for name, by_m in lut_launches.items() if name not in OFF_PATH
            for c in by_m.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")
    # one loop launch per fused search: 7 timed + 1 warm serve searches,
    # one per pool chunk in the fit
    if launches["beam_hop"] + launches["beam_hop_lut"] != 0:
        raise AssertionError(f"the one-hop kernel ran on the main path: "
                             f"{launches}")
    if min(factory_launches[FAMILY_KERNEL[family_of(spec)]]
           for spec, _ in FACTORY_SPECS) <= 0:
        raise AssertionError(f"a family's kernel never launched in the "
                             f"factory phase: {factory_launches}")
    if min(gnn["launches"][name] for name in GNN_KERNELS) <= 0:
        raise AssertionError(f"a bag kernel never launched on the DimeNet "
                             f"path: {gnn['launches']}")
    if min(recsys_launches[name] for name in RECSYS_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the two-tower path never launched "
                             f"in phases 11-12: {recsys_launches}")
    if fit_l2topk <= 0 or launches["l2topk"] <= fit_l2topk \
            or tune_launches["l2topk"] <= 0:
        raise AssertionError("l2topk did not launch in each of fit, serve "
                             "and tune")
    # the fit's AntiHub and kNN take the tensor cores, its medoid and
    # k-means the tile variant; PQ's codec the small one
    if min(fit_by_variant["tc"], fit_by_variant["tile"],
           lut_by_variant["small"]) <= 0:
        raise AssertionError(f"an l2topk variant of the main path never "
                             f"launched: fit {fit_by_variant}, quantize "
                             f"{lut_by_variant}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:     # a failed phase: report, exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
